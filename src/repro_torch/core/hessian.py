"""Calibration: run the model over calibration batches with capture mode
on and accumulate per-module Hessians ``X^T X`` (fp32, streamed over
batches) through the ``hessian_accum`` kernel (its plain version on the
CPU). The kernel seeds its accumulator from the running Hessian, so
``H + X^T X`` is one pass.

Numerical self-healing: if any captured activation of a batch is
non-finite, the whole batch is skipped for every module (counted as
detected and recovered at ``calib.batch``), so the result equals a clean
run over the remaining batches exactly. Every batch costs one host sync
for that check, which also keeps the accumulation from launching on a
batch it would throw away. The ``calib.batch`` fault site poisons one
batch's captures; a batch whose rule does not fire is not touched.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..distributed.activation import get_activation_context
from ..distributed.sharding import axis_size, data_axes_for
from ..kernels import hessian_accum
from ..models.transformer import forward
from ..robustness import faults
from ..robustness.report import current_report
from ..runtime.device import DeviceLike, resolve_device
from .structures import get_capture, registry


def xtx(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """X^T X for X: (N, d) in fp32; optionally mask invalid rows and/or
    fold the result into a running accumulator (returns acc + X^T X)."""
    x = x.float()
    if valid is not None:
        x = x * valid[:, None].float()
    return hessian_accum(x.contiguous(), acc)


def resolve_mesh(mesh, data_axes):
    """An explicit mesh wins; else the activation context's (mesh, batch
    axes); ``data_axes`` defaults to the mesh's conventional data axes.
    Returns (None, None) without a mesh."""
    if mesh is None:
        mesh, ctx_axes = get_activation_context()
        if data_axes is None:
            data_axes = ctx_axes
    if mesh is None:
        return None, None
    if data_axes is None:
        data_axes = data_axes_for(mesh)
    if isinstance(data_axes, str):
        data_axes = (data_axes,)
    return mesh, tuple(data_axes)


def collect_hessians(cfg, params, batches: List[Dict], *,
                     mesh=None, data_axes=None,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Returns {module_name: H_raw = sum X^T X / n_samples} over batches,
    on ``device`` (``params`` must already live there).

    With a mesh (explicit or from the activation context) whose data-axis
    size divides every batch, calibration runs data-parallel and every
    rank returns the same Hessians; otherwise every rank runs the
    single-process path."""
    dev = resolve_device(device)
    if not batches:
        raise ValueError("collect_hessians needs at least one calibration "
                         "batch (got an empty list)")
    mods = registry(cfg)
    mesh, data_axes = resolve_mesh(mesh, data_axes)
    n_shards = axis_size(mesh, data_axes) if mesh is not None else 1
    if n_shards == 1 or any(b["tokens"].shape[0] % n_shards
                            for b in batches):
        mesh, n_shards = None, 1  # the single-process path, on every rank
    part = mesh.index(data_axes) if mesh is not None else 0
    hessians = {m.name: torch.zeros((m.d_in, m.d_in), device=dev)
                for m in mods}
    counts = {m.name: 0.0 for m in mods}
    skipped = 0
    with torch.no_grad():
        for batch in batches:
            poison = faults.poison_scalar("calib.batch")
            share = batch["tokens"].shape[0] // n_shards
            rows = slice(part * share, (part + 1) * share)  # this rank's
            # an encoder/decoder's frames ride beside the tokens
            frames = ({"frontend_embeds": batch["frontend"][rows].to(dev)}
                      if "frontend" in batch else {})
            caps = forward(cfg, params, batch["tokens"][rows].to(dev),
                           capture=True, **frames)["captures"]
            xs = {m.name: get_capture(caps, m) for m in mods}
            if poison != 1.0:  # an injected fault: poison this batch
                xs = {k: (x * poison, v) for k, (x, v) in xs.items()}
            ok = bool(torch.stack([torch.isfinite(x).all()
                                   for x, _ in xs.values()]).all())
            if mesh is not None:  # skipped on every rank if on any
                ok = not mesh.any(not ok, data_axes)
            if not ok:  # sync: one per batch, the skip decision
                skipped += 1
                continue
            for m in mods:
                x, valid = xs[m.name]
                hessians[m.name] = xtx(x, valid, acc=hessians[m.name])
                counts[m.name] += float(x.shape[0]) if valid is None \
                    else float(valid.sum())
    if mesh is not None:  # the partial sums, summed across the ranks
        hessians = {k: mesh.all_reduce(h, data_axes)
                    for k, h in hessians.items()}
        total = mesh.all_reduce(torch.tensor(
            [counts[m.name] for m in mods], dtype=torch.float64), data_axes)
        counts = {m.name: float(c) for m, c in zip(mods, total)}
    if skipped:
        rep = current_report()
        rep.count("detected", "calib.batch", skipped)
        rep.count("recovered", "calib.batch", skipped)
        print(f"[robustness] calib: skipped {skipped}/{len(batches)} "
              f"non-finite calibration batch(es)")
    if skipped == len(batches):
        raise FloatingPointError(
            "every calibration batch produced non-finite activations — "
            "no Hessian could be accumulated")
    # normalize by sample count (keeps damping scale-invariant)
    return {k: h / max(counts[k], 1.0) for k, h in hessians.items()}
