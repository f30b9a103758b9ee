#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 18 (f) and (g) at several learning rates,
and (f) with a fault planted in the mesh step: how far the 2-rank mesh
trainer's 6-step trajectory lies from the single-process trainer's, and
int8_ef's from fp32's.

    python3 scripts/sweep_torch_mesh_lr.py [--lr 3e-7 ...] \
        [--plant none --plant no_update ...] [--collectives]

Phase 4's full-width GPT-2 small (6 layers) and the phase's teacher,
batches and trainer settings (``MESH_TRAIN``) with only the learning
rate changed. The parent trains one process per learning rate and
writes its final params; then two ranks share the card
(``run_ranks``), each training over a ``("data",)`` mesh at every rate
with every plant (int8_ef only without one). The plants break the mesh
step inside the ranks alone, by patching:

* ``no_update``: AdamW returns the params and moments it was given;
* ``half_batch``: every rank takes the first rank's rows of each
  microbatch, so the all-reduced gradient is that of half the batch;
* ``unreduced``: the gradients skip the all-reduce (each rank steps on
  its own half of the batch, divided by the rank count).

Prints, per rank, rate and plant, the numbers phase 18 (f) checks: the
params' largest difference from the parent's; the largest loss gap
between the two trajectories; ``grad_rel``, each step's relative
difference of the gradient norm from the parent's (steps 0 and 1 see
the same params in both); ``update_rel``, ``|d_mesh - d_one| / |d_one|``
over the rank's slices, where ``d`` is the params' change over the 6
steps; then int8's last loss against fp32's and the step seconds.

``--collectives`` then times (f) without a plant at the first rate
three times more, with the mesh's collectives as they are, with one
gloo group a collective and ``dist.all_gather`` for gathers (the
simpler design), and as they are again, and prints each run's step
seconds and each collective's seconds. Needs a GPU (about 2 minutes
for three rates).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402  (the helpers, not the smoke run)

RANK_SCRIPT = """
import sys
sys.path.insert(0, HERE)
import sweep_torch_mesh_lr
sweep_torch_mesh_lr.rank(WORK, LRS, PLANTS, COLLECTIVES)
"""
PLANTS = ("none", "no_update", "half_batch", "unreduced")


def _trainer(torch, cfg, tcfg, lr, compression, teacher, mesh=None):
    from repro_torch.models import model_specs
    from repro_torch.train import Trainer
    return Trainer(cfg, dataclasses.replace(
        tcfg, learning_rate=lr, grad_compression=compression),
        ckpt_dir=tempfile.mkdtemp(), ckpt_every=100, log_every=1,
        teacher_params=teacher, mesh=mesh,
        specs=model_specs(cfg) if mesh is not None else None,
        device="cuda")


def _planted(plant, mesh):
    """Patch the mesh step with ``plant``; returns the undo."""
    from repro_torch.train import train_step as ts

    undo = []

    def patch(obj, name, fn):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    if plant == "no_update":
        patch(ts, "adamw_update", lambda grads, opt, params, **kw:
              (params, opt))
    elif plant == "half_batch":
        rows = ts._rows
        patch(ts, "_rows", lambda batch, part, size: rows(batch, 0, size))
    elif plant == "unreduced":
        reduce = mesh.all_reduce

        def skip_grads(t, axes=None, op="sum"):
            # the aux metrics (4 values), flags and amax stay reduced
            if t.is_floating_point() and t.numel() >= 1024:
                return t.clone()
            return reduce(t, axes, op)
        patch(mesh, "all_reduce", skip_grads)

    def restore():
        for obj, name, fn in reversed(undo):
            setattr(obj, name, fn)
    return restore


def _plain_collectives(mesh):
    """One gloo group a collective and ``dist.all_gather`` for a gather;
    returns the undo."""
    import numpy as np
    import torch
    import torch.distributed as dist

    lanes = mesh._lanes
    mesh._lanes = {k: v[:1] for k, v in lanes.items()}

    def all_gather(a, axes=None):
        t0 = time.perf_counter()
        a = np.ascontiguousarray(a)
        raw = torch.from_numpy(a.reshape(-1).view(np.uint8))
        group = mesh.group(axes)
        parts = [torch.empty_like(raw)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, raw, group=group)
        out = np.concatenate([p.numpy().view(a.dtype).reshape(a.shape)
                              for p in parts])
        mesh._staged("all_gather", a.nbytes, t0)
        return out
    mesh.all_gather = all_gather

    def restore():
        mesh._lanes = lanes
        del mesh.all_gather
    return restore


def rank(work, lrs, plants, collectives):
    """One rank: every (rate, plant) over the mesh, int8_ef unplanted."""
    import numpy as np
    import torch
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.subproc import emit_result, init_rank

    init_rank(timeout=600)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, _ = cs.main_model(torch)
    mesh = make_mesh((torch.distributed.get_world_size(),), ("data",))
    teacher, tcfg = cs.mesh_train_setup(torch)
    out = {}

    def fp32(lr, tag):
        tr = _trainer(torch, cfg, tcfg, lr, "none", teacher, mesh)
        before = {k: list(v) for k, v in mesh.staged.items()}
        st = tr.fit(tr.init_or_restore(params), cs.mesh_train_data(cfg),
                    steps=cs.MESH_TRAIN["total_steps"], save_last=False)
        torch.cuda.synchronize()
        rec = {"losses": [m["loss"] for m in tr.metrics_log],
               "grad_norms": [m["grad_norm"] for m in tr.metrics_log],
               "step_s": [m["step_time"] for m in tr.metrics_log],
               "staged": cs.staged_since(mesh, before)}
        with np.load(os.path.join(work, f"one_{lr}.npz")) as f:
            rec["diff"], rec["update"] = cs.mesh_update_gap(
                torch, st.params, f, params, tr._st_sh.params, mesh)
        tr.ckpt.close()
        out[tag] = rec

    for lr in lrs:
        for plant in plants:
            undo = _planted(plant, mesh)
            try:
                fp32(lr, f"{lr}/{plant}")
            finally:
                undo()
        tr = _trainer(torch, cfg, tcfg, lr, "int8_ef", teacher, mesh)
        tr.fit(tr.init_or_restore(params), cs.mesh_train_data(cfg),
               steps=cs.MESH_TRAIN["total_steps"], save_last=False)
        tr.ckpt.close()
        out[f"{lr}/int8_ef"] = {
            "losses": [m["loss"] for m in tr.metrics_log],
            "step_s": [m["step_time"] for m in tr.metrics_log]}
    if collectives:
        for i, kind in enumerate(("as_is", "plain", "as_is")):
            undo = (_plain_collectives(mesh) if kind == "plain"
                    else (lambda: None))
            try:
                fp32(lrs[0], f"collectives{i}/{kind}")
            finally:
                undo()
    out["staged"] = mesh.staged
    emit_result(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, action="append")
    ap.add_argument("--plant", choices=PLANTS, action="append")
    ap.add_argument("--collectives", action="store_true")
    args = ap.parse_args(argv)
    lrs = args.lr or [1e-5, 1e-6, 3e-7]
    plants = args.plant or ["none"]

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    from repro_torch.launch.subproc import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    work = tempfile.mkdtemp(prefix="sweep_mesh_lr_")
    cfg, params, _ = cs.main_model(torch)
    teacher, tcfg = cs.mesh_train_setup(torch)
    one = {}
    for lr in lrs:
        tr = _trainer(torch, cfg, tcfg, lr, "none", teacher)
        st = tr.fit(tr.init_or_restore(params), cs.mesh_train_data(cfg),
                    steps=cs.MESH_TRAIN["total_steps"], save_last=False)
        tr.ckpt.close()
        np.savez(os.path.join(work, f"one_{lr}.npz"),
                 **{k: t.cpu().numpy() for k, t in cs.tree_paths(st.params)})
        one[lr] = {"losses": [m["loss"] for m in tr.metrics_log],
                   "grad_norms": [m["grad_norm"] for m in tr.metrics_log]}
        print(f"single process, lr {lr}: losses {one[lr]['losses']}, grad "
              f"norms {one[lr]['grad_norms']}", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks(f"HERE = {HERE!r}\nWORK = {work!r}\nLRS = {lrs!r}\n"
                      f"PLANTS = {plants!r}\n"
                      f"COLLECTIVES = {args.collectives!r}\n" + RANK_SCRIPT,
                      2, device="cuda", timeout=900)
    print(f"ranks {time.perf_counter() - t0:.2f} s", flush=True)

    def line(i, lr, tag, f):
        gap = max(abs(a - b) for a, b in zip(f["losses"], one[lr]["losses"]))
        grad_rel = cs.grad_norm_gaps(f["grad_norms"], one[lr]["grad_norms"])
        print(f"rank {i}, lr {lr}, {tag}: params diff {f['diff']:.3e}, "
              f"loss gap {gap:.3e}, grad_rel "
              f"{[float(f'{g:.3e}') for g in grad_rel]}, update_rel "
              f"{cs.update_rel(f['update']):.4e}; losses {f['losses']}; "
              f"step seconds {[round(x, 3) for x in f['step_s']]}; staged "
              + json.dumps(f["staged"]), flush=True)

    for i, r in enumerate(ranks):
        for lr in lrs:
            for plant in plants:
                line(i, lr, f"plant {plant}", r[f"{lr}/{plant}"])
            if "none" in plants:
                f, g = r[f"{lr}/none"], r[f"{lr}/int8_ef"]
                print(f"rank {i}, lr {lr}: int8 last loss {g['losses'][-1]} "
                      f"against fp32's {f['losses'][-1]} (gap "
                      f"{abs(g['losses'][-1] - f['losses'][-1]):.4f}); step "
                      f"seconds {[round(x, 3) for x in g['step_s']]}",
                      flush=True)
        for key in sorted(k for k in r if k.startswith("collectives")):
            line(i, lrs[0], key, r[key])
        print(f"rank {i} staged [calls, bytes, seconds]: "
              + json.dumps(r["staged"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
