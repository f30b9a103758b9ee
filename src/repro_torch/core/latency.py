"""Latency tables (paper §3.2, Appendix E).

For the target inference environment, record the runtime of each prunable
module at every sparsity level. Two backends:

* ``costmodel`` — the analytic roofline of ``runtime.costmodel``, priced
  for the ``HardwareSpec`` the environment names;
* ``measure``  — timing of each module's work on the device (the
  paper's own procedure): on the card, a replay of the module's calls
  captured in a CUDA graph, between CUDA events (device time, as the
  reference times one compiled program a call); ``perf_counter`` on the
  CPU.

A measurement that fails raises, with one exception, the degradation
rung of ``build_table``: an injected fault at the ``latency.measure``
site or a CUDA out-of-memory error opens that site's breaker, and the
cost model prices this table and every later measured one.

``runtime_of`` maps a per-module level assignment to end-to-end runtime,
which is what gives ZipLM its speedup guarantee. ``build_table`` reads a
measured table from, and stores it in, the persistent latency cache
(``core/latency_cache.py``) when a ``cache_dir`` or
``$ZIPLM_LATENCY_CACHE`` names one.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import compute_dtype
from ..robustness import faults
from ..robustness.healing import demotable
from ..robustness.report import current_report
from ..runtime import costmodel as cm
from ..runtime.device import DeviceLike, resolve_device
from .structures import UNITS, PrunableModule, level_grid, registry


# what the measure backend has timed in this process: ``_time_fn`` calls
# and the timed calls they made (a cache hit adds none), and the cache
# files that a lookup found corrupt or foreign (``core/latency_cache.py``)
TIMING_STATS = {"calls": 0, "reps": 0,
                "cache_corrupt": 0, "cache_foreign": 0,
                "cache_flagged": []}


@dataclass
class LatencyTable:
    env: cm.InferenceEnv
    # kind -> (levels, seconds) aligned arrays; levels = structures removed
    grids: Dict[str, np.ndarray] = field(default_factory=dict)
    times: Dict[str, np.ndarray] = field(default_factory=dict)
    base: float = 0.0

    def module_time(self, kind: str, removed: int) -> float:
        return float(np.interp(removed, self.grids[kind], self.times[kind]))

    def level_times(self, mod: PrunableModule) -> np.ndarray:
        g = np.asarray(level_grid(mod))
        return np.interp(g, self.grids[mod.kind], self.times[mod.kind])

    def runtime_of(self, assignment: Dict[str, int], mods) -> float:
        """assignment: module name -> structures removed."""
        by_name = {m.name: m for m in mods}
        t = self.base
        for name, removed in assignment.items():
            t += self.module_time(by_name[name].kind, removed)
        return t

    def dense_runtime(self, mods) -> float:
        return self.base + sum(self.module_time(m.kind, 0) for m in mods)


def _kinds_for(cfg) -> List[str]:
    """Unit kinds with prunable modules in cfg, in UNITS order."""
    return [kind for kind, u in UNITS.items() if u.layer_modules(cfg, 0)]


def _grid_for(cfg, kind: str) -> np.ndarray:
    """Level grid of a kind — the database's own ``level_grid``, so the
    table and the database always agree on what a level means."""
    for m in registry(cfg):
        if m.kind == kind:
            return np.asarray(level_grid(m))
    raise ValueError(f"no prunable modules of kind {kind!r} in {cfg.name}")


def build_costmodel_table(cfg, env: cm.InferenceEnv) -> LatencyTable:
    tab = LatencyTable(env=env)
    for kind in _kinds_for(cfg):
        grid = _grid_for(cfg, kind)
        unit = UNITS[kind]
        tab.grids[kind] = grid
        tab.times[kind] = np.asarray(
            [unit.cost_time(cfg, env, int(removed)) for removed in grid])
    tab.base = cm.base_time(cfg, env)
    return tab


# ----------------------------------------------------------------------
# measured backend (paper's procedure, on the device)
# ----------------------------------------------------------------------

def _attn_timing_module(cfg, env: cm.InferenceEnv, groups: int, gen, dt, dev):
    """The (fn, args) pair timed for one attention level: the q/k/v
    projections, GQA repeat, softmax(QK^T)V and the out-projection."""
    hq = groups * cfg.q_per_kv
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    x = torch.randn((env.tokens, d), generator=gen).to(dev, dt)
    wq = torch.zeros((d, hq * dh), dtype=dt, device=dev)
    wk = torch.zeros((d, groups * dh), dtype=dt, device=dev)
    wv = torch.zeros((d, groups * dh), dtype=dt, device=dev)
    wo = torch.zeros((hq * dh, d), dtype=dt, device=dev)

    def attn_mod(x, wq, wk, wv, wo, _b=env.batch):
        q = (x @ wq).reshape(_b, -1, hq, dh)
        k = (x @ wk).reshape(_b, -1, groups, dh)
        v = (x @ wv).reshape(_b, -1, groups, dh)
        kr = k.repeat_interleave(hq // groups, dim=2)
        vr = v.repeat_interleave(hq // groups, dim=2)
        lg = torch.einsum("bqhd,bkhd->bhqk", q, kr)
        p = torch.softmax(lg.float(), -1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
        return o.reshape(x.shape[0], -1) @ wo

    return attn_mod, (x, wq, wk, wv, wo)


def _ffn_timing_module(cfg, tokens: int, f_live: int, gen, dt, dev):
    """The (fn, args) pair timed for one FFN level (as in the reference:
    x @ w1, SiLU, @ w2)."""
    x = torch.randn((tokens, cfg.d_model), generator=gen).to(dev, dt)
    w1 = torch.zeros((cfg.d_model, f_live), dtype=dt, device=dev)
    w2 = torch.zeros((f_live, cfg.d_model), dtype=dt, device=dev)

    def ffn_mod(x, w1, w2):
        return F.silu(x @ w1) @ w2

    return ffn_mod, (x, w1, w2)


def _time_fn(fn, *args, reps: int, warmup: int, dev: torch.device) -> float:
    """Seconds per call of ``fn(*args)``.

    On the card: ``warmup`` calls on a side stream, ``reps`` calls
    captured in one CUDA graph, and one replay of it timed between two
    CUDA events, so the time is the device's and not the host's launch
    path (a module of a dozen small ops would otherwise be priced by its
    launches). A graph of one call replayed ``reps`` times would add each
    replay's launch, about 2.5 us a call on an H100 (a fifth of the
    smallest timing modules). A module that cannot be captured raises.
    On the CPU: the fastest of ``reps`` calls, each timed by
    ``perf_counter``, after ``warmup`` untimed ones. The host's clock
    also counts the time the process waited for a core, and on a loaded
    host one such wait inside a mean of one call priced a logits head at
    three times all the modules together, above every target's budget;
    the fastest call is the one no wait reached. The ``latency.measure`` fault site is hit first."""
    faults.hit("latency.measure")
    TIMING_STATS["calls"] += 1
    TIMING_STATS["reps"] += reps
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # at least one: cuBLAS's first call
            for _ in range(max(1, warmup)):
                fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn(*args)
        graph.replay()  # untimed: the first replay uploads the graph
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def build_measured_table(cfg, env: cm.InferenceEnv, dev: torch.device, *,
                         grid_subsample: int = 4, reps: int = 5,
                         warmup: int = 1) -> LatencyTable:
    """Measure module runtimes on ``dev`` (``_time_fn``): each the mean of
    ``reps`` calls in one graph replay on the card, the fastest of them on
    the CPU, after ``warmup`` untimed ones; the level grid is subsampled
    (interpolation fills the gaps)."""
    tab = LatencyTable(env=env)
    dt = compute_dtype(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for kind in _kinds_for(cfg):
            full_grid = _grid_for(cfg, kind)
            grid = np.unique(np.concatenate(
                [full_grid[::grid_subsample], full_grid[-1:]]))
            unit = UNITS[kind]
            ts = []
            for removed in grid:
                spec = unit.timing_spec(cfg, env, int(removed))
                if spec is None:  # fully-dropped module: nothing to run
                    ts.append(0.0)
                    continue
                if spec["module"] == "attn":
                    fn, args = _attn_timing_module(cfg, env, spec["groups"],
                                                   gen, dt, dev)
                else:
                    fn, args = _ffn_timing_module(cfg, spec["tokens"],
                                                  spec["f_live"], gen, dt, dev)
                ts.append(_time_fn(fn, *args, reps=reps, warmup=warmup,
                                      dev=dev))
            tab.grids[kind] = grid
            tab.times[kind] = np.asarray(ts)
        # base: the logits head
        x = torch.randn((env.tokens, cfg.d_model), generator=gen).to(dev, dt)
        wv = torch.zeros((cfg.d_model, cfg.vocab_size), dtype=dt, device=dev)
        tab.base = _time_fn(torch.matmul, x, wv, reps=reps, warmup=warmup,
                            dev=dev)
    return tab


def build_table(cfg, env: cm.InferenceEnv, backend: str = "costmodel", *,
                device: DeviceLike = None, cache_dir: Optional[str] = None,
                refresh: bool = False, **kw) -> LatencyTable:
    """The latency table of ``cfg`` in ``env``; ``measure`` times the
    modules on ``device``.

    A measured table goes through the persistent cache
    (``core/latency_cache.py``) when ``cache_dir`` is given or
    ``$ZIPLM_LATENCY_CACHE`` is set (an opt-in, so a bare run stays
    hermetic): a hit is returned without timing anything, a miss is
    measured and stored. ``refresh=True`` measures again and overwrites
    the entry. The cost-model table is cheap and never cached.

    Degradation: an injected fault at ``latency.measure`` or a
    ``torch.cuda.OutOfMemoryError`` while measuring opens that site's
    breaker in the ambient report, quarantines the key's cache file, and
    this call and every later ``measure`` call under the report return
    ``build_costmodel_table``. Any other failure raises, as does a
    demotion in an env with no ``HardwareSpec`` to price (a ValueError
    chained to the measurement's error)."""
    dev = resolve_device(device)
    if backend == "costmodel":
        return build_costmodel_table(cfg, env)
    if backend == "measure":
        rep = current_report()
        if rep.breaker_open("latency.measure"):
            return build_costmodel_table(cfg, env)
        lc = None
        if cache_dir is not None or os.environ.get("ZIPLM_LATENCY_CACHE"):
            from .latency_cache import LatencyCache
            lc = LatencyCache(cache_dir)
            tab = None if refresh else lc.get(cfg, env, dev, **kw)
            if tab is not None:
                return tab
        try:
            tab = build_measured_table(cfg, env, dev, **kw)
        except Exception as e:
            if not demotable(e, "latency.measure"):
                raise
            if env.hw is None:
                raise ValueError(
                    "the latency measurement failed and this InferenceEnv "
                    "has no HardwareSpec, so the cost model cannot price "
                    "the table instead") from e
            rep.trip("latency.measure", reason=f"measurement failed: {e!r}")
            if lc is not None:
                lc.quarantine(cfg, env, dev, **kw)
            return build_costmodel_table(cfg, env)
        if lc is not None:
            lc.put(cfg, env, tab, dev, **kw)
        return tab
    raise ValueError(f"unknown latency backend {backend!r}")
