"""Training launcher: the distillation trainer on one device, or on
the ranks of a data-parallel mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
      --steps 10 --batch 8 --seq 512

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path instead
(with ``--smoke`` for the reduced same-family config). Weights are
random, drawn from seed 0; batches are the synthetic stream, resumed at
the restored step. Checkpoints go to ``--ckpt-dir`` (a fresh temporary
directory by default; give the ranks of a mesh one directory).

With ``WORLD_SIZE`` above 1 in the environment (one process a rank,
from ``launch.subproc.run_ranks`` or ``torchrun``) every rank joins the
process group (``launch.subproc.init_rank``, unless the caller already
did), and the trainer runs over a ``("data",)`` mesh of all ranks with
``mesh_config_for`` and ``models.model_specs``: FSDP slices, and
``--grad-compression int8_ef`` compressing the all-reduce. On one
process ``int8_ef`` has nothing to compress and the trainer raises.
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
    from ..distributed.sharding import make_mesh, mesh_config_for
    from ..models import model_init, model_specs
    from ..optim.adamw import tree_leaves
    from ..runtime.device import resolve_device
    from ..train.trainer import Trainer

    dev = resolve_device(args.device)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch.distributed as dist

        from .subproc import init_rank
        if not dist.is_initialized():
            init_rank(device=args.device)
        mesh = make_mesh((dist.get_world_size(),), ("data",))
    if args.ckpt_dir is None:  # the first rank's, on a mesh
        import tempfile
        if mesh is None or mesh.index() == 0:
            args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
        if mesh is not None:
            args.ckpt_dir = mesh.broadcast_object(args.ckpt_dir)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {dev}"
          + (f", {mesh.size} ranks" if mesh is not None else ""))
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression)
    trainer = Trainer(cfg, tcfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, mesh=mesh,
                      mc=mesh_config_for(mesh) if mesh else None,
                      specs=model_specs(cfg) if mesh else None,
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
