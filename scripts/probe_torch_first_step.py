#!/usr/bin/env python3
"""What a process's first train step on the card waits for.

    python3 scripts/probe_torch_first_step.py

Runs four fresh processes, each drawing phase 4's GPT-2 small (6 full
width layers) and a teacher, then timing the first two steps of the
distillation trainer (``chip_smoke.py``'s ``MESH_TRAIN`` settings, one
process) after one of: nothing; entering ``deterministic_algorithms()``
once (its first ``torch.use_deterministic_algorithms`` call imports
``torch._inductor.config``); a first forward and backward of a tiny
GPT-2 without the deterministic mode; a first train step of the tiny
GPT-2. Prints, per process, the preparation's seconds and the two step
seconds. Needs a GPU (about a minute).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("none", "deterministic_mode", "tiny_forward_backward",
         "tiny_train_step")


def run(mode: str) -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.data import synthetic_stream
    from repro_torch.distill.losses import distillation_loss
    from repro_torch.models import model_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import Trainer, make_train_state, make_train_step
    from repro_torch.train.train_step import deterministic_algorithms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, _ = cs.main_model(torch)
    teacher, tcfg = cs.mesh_train_setup(torch)
    tiny = GPT2_SMALL.replace(num_layers=2, d_model=64, d_ff=128,
                              num_heads=4, num_kv_heads=4, head_dim=16,
                              vocab_size=256)
    t0 = time.perf_counter()
    if mode == "deterministic_mode":
        with deterministic_algorithms():
            pass
    elif mode != "none":
        tp = model_init(tiny, torch.Generator().manual_seed(0), device="cuda")
        tt = model_init(tiny, torch.Generator().manual_seed(1), device="cuda")
        batch = next(synthetic_stream(tiny, 8, 32, seed=3))
        if mode == "tiny_forward_backward":
            live = tree_map(lambda x: x.detach().requires_grad_(True), tp)
            total, _ = distillation_loss(
                tiny, live, tt, {k: v[:4] for k, v in batch.items()},
                l_logit=1.0, l_token=0.5)
            torch.autograd.grad(total, tree_leaves(live))
        else:
            step = make_train_step(tiny, tcfg, teacher_params=tt,
                                   device="cuda")
            _, m = step(make_train_state(tiny, tp, tcfg), batch)
            float(m["loss"])
    torch.cuda.synchronize()
    prepared = time.perf_counter() - t0
    tr = Trainer(cfg, tcfg, ckpt_dir=tempfile.mkdtemp(), ckpt_every=100,
                 log_every=1, teacher_params=teacher, device="cuda")
    tr.fit(tr.init_or_restore(params), cs.mesh_train_data(cfg), steps=2,
           save_last=False)
    tr.ckpt.close()
    print(f"{mode}: preparation {prepared:.3f} s, first steps "
          f"{[round(m['step_time'], 3) for m in tr.metrics_log]} s",
          flush=True)


def main() -> int:
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    for mode in MODES:  # each in a process of its own
        subprocess.run([sys.executable, os.path.abspath(__file__), mode],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
