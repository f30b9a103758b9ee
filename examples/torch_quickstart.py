"""Quickstart on the PyTorch port: one-shot ZipLM pruning of a small
GPT2-style model, on the GPU (``--device cpu`` runs the plain PyTorch path).

Trains a tiny model on the synthetic stream, then produces a family of
pruned models with guaranteed speedups for a chosen inference environment,
priced by the cost model on the H100 SXM data sheet
(``runtime.costmodel.H100_SXM``).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

# the train step runs under torch.use_deterministic_algorithms, which on
# CUDA needs a fixed cuBLAS workspace, set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import GPT2_SMALL
from repro_torch.configs.base import TrainConfig
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.core.shrink import shrink
from repro_torch.data import calibration_batches, synthetic_stream
from repro_torch.models import model_init
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
from repro_torch.runtime.device import resolve_device
from repro_torch.train import make_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = GPT2_SMALL.replace(name="gpt2-tiny", num_layers=4, d_model=96,
                             d_ff=384, num_heads=6, num_kv_heads=6,
                             head_dim=16, vocab_size=384, dtype="float32")
    print(f"model: {cfg.name}  params={cfg.num_params()/1e6:.2f}M")

    # 1) train briefly so pruning has signal to preserve
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=150)
    step = make_train_step(cfg, tcfg, device=dev)
    state = make_train_state(cfg, params, tcfg)
    data = synthetic_stream(cfg, 16, 64, seed=7)
    for i in range(150):
        state, m = step(state, next(data))
        if i % 50 == 0:
            print(f"  step {i:4d} loss {float(m['loss']):.4f}")
    params = state.params

    # 2) inference specification (paper §3.2): batch, seq, device
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=H100_SXM)
    calib = calibration_batches(cfg, 32, 64, batch=8)

    # 3) one run -> the whole family, each with a speedup guarantee; the
    # SPDY search is one population-batched pass shared by all targets
    res = oneshot_prune(cfg, params, calib, env, targets=[1.5, 2.0, 3.0],
                        search_steps=40, search_pop=16, verbose=False,
                        device=dev)
    print(f"\ndense loss {res.dense_loss:.4f}")
    for t, v in sorted(res.variants.items()):
        pm = shrink(cfg, v.params, res.db, v.assignment, device=dev)
        print(f"  target {t:>4}x -> achieved {v.speedup:.2f}x  "
              f"loss {v.calib_loss:.4f}  "
              f"stack params {pm.encoder_params()/1e3:.0f}k")
    return res


if __name__ == "__main__":
    main()
