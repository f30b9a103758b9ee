"""Family server: one process hosts a whole speedup-target family.

Members are materialised on the device: ``SnapshotCache.apply`` stitches
a target's per-module snapshots into the dense tree (one gather per
module kind, no host round trip), then ``shrink_from_stitched`` slices it
into a physically smaller :class:`PrunedModel`. Standing up N members
costs N device stitches over one resident snapshot stack, not N
parameter reloads.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

from ..core.database import ModuleDB, SnapshotCache
from ..core.shrink import shrink_from_stitched
from .engine import DenseServeModel, PrunedServeModel, ServeEngine, \
    ServeReport
from .workload import CLASS_SPEEDUP, Request

DENSE_TARGET = 1.0


class FamilyServer:
    """Hosts the dense model and every pruned member; routes by latency
    class.

    ``assignments``: {target_speedup: per-module level assignment}, e.g.
    ``{t: v.assignment for t, v in OneShotResult.variants.items()}``.
    ``params`` live on the device the members are served on.

    Routing: a request's latency class demands a minimum speedup
    (:data:`~repro_torch.serve.workload.CLASS_SPEEDUP`); the router picks
    the smallest member target that meets it (the best quality within
    the latency budget), and the fastest member when none does.
    """

    def __init__(self, cfg, params, db: Dict[str, ModuleDB],
                 assignments: Dict[float, Dict[str, int]], *,
                 max_len: int, num_slots: int = 4,
                 include_dense: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg = cfg
        self.snapshots = SnapshotCache(
            cfg, db, device=params["embed"]["table"].device)
        self.members: Dict[float, ServeEngine] = {}
        if include_dense:
            self.members[DENSE_TARGET] = ServeEngine(
                DenseServeModel(cfg, params, max_len), num_slots,
                clock=clock)
        for target, assignment in sorted(assignments.items()):
            stitched = self.snapshots.apply(params, assignment)
            pm = shrink_from_stitched(cfg, stitched, db, assignment)
            self.members[float(target)] = ServeEngine(
                PrunedServeModel(pm, max_len), num_slots, clock=clock)

    def warmup(self, prompt_lens=(8,)):
        for eng in self.members.values():
            eng.warmup(prompt_lens)

    def route(self, latency_class: str) -> float:
        """Member target for a latency class (see the class docstring)."""
        need = CLASS_SPEEDUP.get(latency_class, 1.0)
        ok = [t for t in self.members if t >= need]
        return min(ok) if ok else max(self.members)

    def run(self, requests: List[Request]) -> Dict[float, ServeReport]:
        """Partition a stream by routed member and serve each partition."""
        parts: Dict[float, List[Request]] = {}
        for r in requests:
            parts.setdefault(self.route(r.latency_class), []).append(r)
        return {t: self.members[t].run(reqs)
                for t, reqs in sorted(parts.items())}
