"""Baseline structured pruners the paper compares against:

* ``magnitude``: rank structures by summed squared weight magnitude, with
  no Hessian and no weight update (the classic baseline ZipLM unifies);
* ``fisher``: a diagonal-Fisher saliency sum(g^2 * w^2), approximated with
  the activation second moment diag(H), also without the update.

Both share ZipLM's latency table and a uniform level choice, so a
comparison isolates the pruning criterion (the paper's Table 2, §4.3).
They run on the host in numpy and produce the port's ``ModuleDB``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .database import ModuleDB
from .latency import LatencyTable
from .structures import get_matrix, level_grid, registry


def structure_scores(W: np.ndarray, gs: int, kind: str = "magnitude",
                     h_diag: np.ndarray = None) -> np.ndarray:
    n = W.shape[0] // gs
    Wb = np.asarray(W, np.float64).reshape(n, gs, -1)
    if kind == "fisher" and h_diag is not None:
        d = np.asarray(h_diag, np.float64).reshape(n, gs)[:, :, None]
        return np.sum(Wb * Wb * d, axis=(1, 2))
    return np.sum(Wb * Wb, axis=(1, 2))


def baseline_database(cfg, params, hessians=None, kind: str = "magnitude"
                      ) -> Dict[str, ModuleDB]:
    """A ``ModuleDB`` per module whose snapshots are plain row maskings
    (no OBS update), removing structures in ascending saliency.
    ``hessians`` (module name -> (d_in, d_in) tensor) feed ``fisher``."""
    db: Dict[str, ModuleDB] = {}
    for mod in registry(cfg):
        W = get_matrix(cfg, params, mod).detach().float().cpu().numpy()
        hd = None
        if hessians is not None and mod.name in hessians:
            hd = torch.diagonal(hessians[mod.name]).double().cpu().numpy()
        scores = structure_scores(W, mod.group_size, kind, hd)
        order = np.argsort(scores)  # least salient first
        levels = np.asarray(level_grid(mod))
        snaps = np.zeros((len(levels), *W.shape), np.float16)
        errs = np.zeros(len(levels))
        base = float(np.sum(scores))
        for i, removed in enumerate(levels):
            mask = np.ones(W.shape[0], np.float32)
            for g in order[:removed]:
                mask[g * mod.group_size:(g + 1) * mod.group_size] = 0.0
            snaps[i] = (W * mask[:, None]).astype(np.float16)
            errs[i] = float(np.sum(scores[order[:removed]]))
        priors = np.sqrt(np.clip(errs / max(base, 1e-30), 0, 1))
        db[mod.name] = ModuleDB(mod=mod, levels=levels, snapshots=snaps,
                                errors=errs, priors=priors, base_norm=base,
                                order=order.astype(np.int32))
    return db


def uniform_assignment(cfg, table: LatencyTable, target_speedup: float
                       ) -> Dict[str, int]:
    """Uniform per-layer levels meeting the budget (no SPDY): raise one
    shared sparsity fraction until the latency table says the target
    holds."""
    mods = registry(cfg)
    dense = table.dense_runtime(mods)
    budget = dense / target_speedup
    for frac in np.linspace(0.0, 1.0, 201):
        a = {}
        for m in mods:
            levels = np.asarray(level_grid(m))
            want = int(round(frac * m.n_structures))
            a[m.name] = int(levels[np.searchsorted(levels, want)])
        rt = table.base + sum(
            table.module_time(m.kind, a[m.name]) for m in mods)
        if rt <= budget:
            return a
    return {m.name: m.n_structures for m in mods}
