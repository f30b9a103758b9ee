"""End-to-end example on the PyTorch port: train a small model for a few
hundred steps, then run the gradual ZipLM pipeline (prune ->
distill-finetune -> export) producing a family of compressed models, on
the GPU (``--device cpu`` runs the plain PyTorch path). Priced by the cost
model on the H100 SXM data sheet (``runtime.costmodel.H100_SXM``).

This is the paper's §4.1 workflow at a small scale; scale knobs are CLI
flags. With --full it uses a ~100M model and 200 train steps; default is a
fast reduced run. Checkpoints go under ``--ckpt`` (by default a directory
in the system's temporary directory), and re-running after a kill resumes
the family at the interrupted (target, stage).

  PYTHONPATH=src python examples/torch_gradual_pruning.py [--full] \
      [--device cpu]
"""
import argparse
import os
import sys
import tempfile

# the train step runs under torch.use_deterministic_algorithms, which on
# CUDA needs a fixed cuBLAS workspace, set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import GPT2_SMALL
from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline import gradual_prune
from repro_torch.data import calibration_batches, synthetic_stream
from repro_torch.models import model_init
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
from repro_torch.runtime.device import resolve_device
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 200 pretrain steps")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ziplm_torch_example"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full:
        cfg = GPT2_SMALL.replace(name="gpt2-100m", num_layers=8,
                                 d_model=512, d_ff=2048, num_heads=8,
                                 num_kv_heads=8, vocab_size=50257)
        pretrain_steps, ft_steps, batch, seq = 200, 60, 8, 256
    else:
        cfg = GPT2_SMALL.replace(name="gpt2-tiny", num_layers=4, d_model=96,
                                 d_ff=384, num_heads=6, num_kv_heads=6,
                                 head_dim=16, vocab_size=384,
                                 dtype="float32")
        pretrain_steps, ft_steps, batch, seq = 120, 20, 16, 64
    print(f"model: {cfg.name} params={cfg.num_params()/1e6:.1f}M")

    # pretrain with the fault-tolerant trainer (checkpoints + watchdog)
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10,
                       total_steps=pretrain_steps)
    trainer = Trainer(cfg, tcfg, ckpt_dir=os.path.join(args.ckpt, "dense"),
                      ckpt_every=50, device=dev)
    state = trainer.init_or_restore(params)
    data = synthetic_stream(cfg, batch, seq, seed=7,
                            start_step=int(state.step))
    state = trainer.fit(state, data, steps=pretrain_steps)
    trainer.ckpt.close()
    # a run resumed at its last step takes none and logs no loss
    loss = (f"loss {trainer.metrics_log[-1]['loss']:.4f}"
            if trainer.metrics_log else "no step taken")
    print(f"pretrained to step {int(state.step)}, {loss}")

    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=H100_SXM)
    calib = calibration_batches(cfg, 32, seq, batch=8)
    ft_cfg = TrainConfig(learning_rate=5e-4, warmup_steps=2,
                         total_steps=ft_steps, distill_logit=1.0,
                         distill_token=0.5)
    # a step-indexed data factory (not a bare iterator) makes the family
    # run resumable bit-exactly: re-running this script after a kill picks
    # up at the interrupted (target, stage) instead of starting over
    data = lambda step: synthetic_stream(cfg, batch, seq, seed=99,
                                         start_step=step)
    variants = gradual_prune(cfg, state.params, env, [1.5, 2.0, 3.0],
                             data, calib, tcfg=ft_cfg,
                             finetune_steps=ft_steps,
                             search_steps=25, search_pop=16, seed=0,
                             ckpt_dir=args.ckpt, verbose=True, device=dev)
    print("\nfamily:")
    for v in variants:
        print(f"  {v.target}x -> {v.achieved:.2f}x  "
              f"loss {v.loss_before_ft:.4f}->{v.loss_after_ft:.4f}  "
              f"stack {v.pruned.encoder_params()/1e6:.2f}M params")
    return variants


if __name__ == "__main__":
    main()
