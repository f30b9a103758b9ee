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


def collect_hessians(cfg, params, batches: List[Dict], *,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Returns {module_name: H_raw = sum X^T X / n_samples} over batches,
    on ``device`` (``params`` must already live there)."""
    dev = resolve_device(device)
    if not batches:
        raise ValueError("collect_hessians needs at least one calibration "
                         "batch (got an empty list)")
    mods = registry(cfg)
    hessians = {m.name: torch.zeros((m.d_in, m.d_in), device=dev)
                for m in mods}
    counts = {m.name: 0.0 for m in mods}
    skipped = 0
    with torch.no_grad():
        for batch in batches:
            poison = faults.poison_scalar("calib.batch")
            # an encoder/decoder's frames ride beside the tokens
            frames = ({"frontend_embeds": batch["frontend"].to(dev)}
                      if "frontend" in batch else {})
            caps = forward(cfg, params, batch["tokens"].to(dev),
                           capture=True, **frames)["captures"]
            xs = {m.name: get_capture(caps, m) for m in mods}
            if poison != 1.0:  # an injected fault: poison this batch
                xs = {k: (x * poison, v) for k, (x, v) in xs.items()}
            ok = torch.stack([torch.isfinite(x).all()
                              for x, _ in xs.values()]).all()
            if not bool(ok):  # sync: one per batch, the skip decision
                skipped += 1
                continue
            for m in mods:
                x, valid = xs[m.name]
                hessians[m.name] = xtx(x, valid, acc=hessians[m.name])
                counts[m.name] += float(x.shape[0]) if valid is None \
                    else float(valid.sum())
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
