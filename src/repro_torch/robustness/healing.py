"""Self-healing primitives: bounded I/O retry with backoff, the damping
escalation ladder, and finiteness checks. Pure helpers: the sites that
use them (checkpoint writes, stage artifacts, Algorithm 1) live with the
code they heal."""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from . import faults
from .report import current_report

# damping-escalation ladder: retries beyond the caller's damp, each one
# decade up (damp * 10**k), bounded so a hopeless Hessian fails loudly
DAMP_RETRIES = 4


def retry_io(fn: Callable[[], object], *, site: str, attempts: int = 3,
             backoff_s: float = 0.05
             ) -> Tuple[object, Optional["faults.FaultRule"]]:
    """Run ``fn`` with bounded retry and exponential backoff on
    ``OSError`` (injected :class:`~repro_torch.robustness.faults.
    FaultIOError`\\ s included: ``site`` is hit inside the retried
    region).

    Returns ``(fn(), fired_rule)``; the rule lets callers apply
    post-write modes (``corrupt``). Re-raises the last ``OSError`` after
    ``attempts`` failures, counted as detected."""
    rep = current_report()
    last: Optional[OSError] = None
    for a in range(attempts):
        try:
            rule = faults.hit(site)
            out = fn()
            if a:
                rep.count("recovered", site)
            return out, rule
        except OSError as e:
            last = e
            rep.count("retries", site)
            if a < attempts - 1:
                time.sleep(backoff_s * (2 ** a))
    rep.count("detected", site)
    raise last


def demotable(e: BaseException, site: str) -> bool:
    """Whether the degradation rung at ``site`` (``latency.measure``,
    ``spdy.batched_eval``) absorbs ``e``: a fault injected at that same
    site, or the card running out of memory. Anything else raises, a
    fault injected at another site (``kernel.pallas`` inside the timed or
    scored forward) included, so no other error is hidden behind the
    cost model or the serial search."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(e, faults.INJECTED) and e.site == site


def damp_schedule(damp: float, retries: int = DAMP_RETRIES) -> List[float]:
    """The percdamp escalation ladder ``damp * 10**k``; rung 0 is exactly
    the caller's damp."""
    return [damp * (10.0 ** k) for k in range(retries + 1)]


def all_finite(*arrays) -> bool:
    """True iff every element of every tensor (on any device) or host
    array is finite."""
    return all(bool(torch.isfinite(torch.as_tensor(a)).all())
               for a in arrays)
