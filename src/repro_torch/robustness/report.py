"""RobustnessReport: faults injected/detected/recovered, degradation
demotions, retries, and quarantined artifacts, plus the per-site
circuit breakers that make each demotion a one-way, once-logged event.

A report is ambient: library code calls :func:`current_report` and
counts into whatever scope the caller opened (``gradual_prune`` opens
one per family run; the module-level default catches everything else).
Counting is additive and never changes numerics, so code under an
untouched default report gives the same bits as code under a scoped one.

The fault sites (``robustness/faults.py``) count what they inject, the
healing paths what they detect, retry and recover, and the degradation
rungs (``latency.measure``, ``spdy.batched_eval``) trip their breakers.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

BUCKETS = ("injected", "detected", "recovered", "retries", "demotions")


class RobustnessReport:
    """Per-site counters and circuit breakers. Every mutation holds the
    lock: the checkpoint worker and a family run's export thread count
    into the report beside the main thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, Dict[str, int]] = {b: {} for b in BUCKETS}
        self.quarantined: List[str] = []
        self.notes: List[str] = []
        self._open: set = set()

    # -- counters ------------------------------------------------------
    def count(self, bucket: str, site: str, n: int = 1):
        with self._lock:
            d = self.counts[bucket]
            d[site] = d.get(site, 0) + n

    def total(self, bucket: str) -> int:
        with self._lock:
            return sum(self.counts[bucket].values())

    def quarantine(self, path: str, site: str = "artifact"):
        with self._lock:
            self.quarantined.append(path)
        self.count("detected", site)

    def note(self, msg: str):
        """Record ``msg`` among the notes and print it."""
        with self._lock:
            self.notes.append(msg)
        print(msg)

    # -- circuit breakers ----------------------------------------------
    def breaker_open(self, site: str) -> bool:
        with self._lock:
            return site in self._open

    def trip(self, site: str, reason: str = ""):
        """Open ``site``'s breaker; the demotion is counted and logged
        exactly once per site per report."""
        with self._lock:
            first = site not in self._open
            self._open.add(site)
        if first:
            self.count("demotions", site)
            self.note(f"[robustness] demoted {site}"
                      + (f": {reason}" if reason else ""))

    # -- summary -------------------------------------------------------
    def as_dict(self) -> Dict:
        with self._lock:
            return {"counts": {b: dict(v) for b, v in self.counts.items()},
                    "breakers_open": sorted(self._open),
                    "quarantined": list(self.quarantined),
                    "notes": list(self.notes)}

    def __repr__(self):
        parts = [f"{b}={self.total(b)}" for b in BUCKETS]
        with self._lock:
            n_quarantined = len(self.quarantined)
        return f"RobustnessReport({', '.join(parts)}, " \
               f"quarantined={n_quarantined})"


_DEFAULT = RobustnessReport()
_STACK: List[RobustnessReport] = [_DEFAULT]


def current_report() -> RobustnessReport:
    return _STACK[-1]


@contextmanager
def report_scope(report: Optional[RobustnessReport] = None):
    """Make ``report`` (or a fresh one) the ambient report within the
    block; yields it."""
    rep = report if report is not None else RobustnessReport()
    _STACK.append(rep)
    try:
        yield rep
    finally:
        _STACK.pop()
