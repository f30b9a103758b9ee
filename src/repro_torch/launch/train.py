"""Training launcher: the distillation trainer on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
      --steps 10 --batch 8 --seq 512

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path instead
(with ``--smoke`` for the reduced same-family config). Weights are
random, drawn from seed 0; batches are the synthetic stream, resumed at
the restored step. Checkpoints go to ``--ckpt-dir`` (a fresh temporary
directory by default).
"""
from __future__ import annotations

import os

# the train step runs under torch.use_deterministic_algorithms, which on
# CUDA needs a fixed cuBLAS workspace, set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; defaults to a fresh "
                         "tempfile.mkdtemp so concurrent runs can't "
                         "collide")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config, smoke_config
    from ..configs.base import TrainConfig
    from ..data import synthetic_stream
    from ..models import model_init
    from ..optim.adamw import tree_leaves
    from ..runtime.device import resolve_device
    from ..train.trainer import Trainer

    dev = resolve_device(args.device)
    if args.ckpt_dir is None:
        import tempfile
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {dev}")
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression)
    trainer = Trainer(cfg, tcfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      install_signal_handler=True, device=dev)
    state = trainer.init_or_restore(params)
    data = synthetic_stream(cfg, args.batch, args.seq,
                            start_step=int(state.step))
    state = trainer.fit(state, data, steps=args.steps)
    trainer.ckpt.close()
    # a run resumed at its last step takes none and logs no loss
    loss = (f"final loss {trainer.metrics_log[-1]['loss']:.4f}"
            if trainer.metrics_log else "no step taken")
    print(f"[train] done at step {int(state.step)}; {loss}; "
          f"stragglers flagged: {trainer.watchdog.flagged}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
