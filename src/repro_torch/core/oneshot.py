"""Post-training / one-shot ZipLM pruning (paper §4.3): calibrate ->
Hessians -> database -> structured SPDY over all speedup targets ->
stitched models.

A single run produces the whole family of compressed models, one per
speedup target, each with a runtime guarantee in the given environment.
The family is searched in one pass (`spdy.search_family`); each round's
unique candidates are stitched on the device (`SnapshotCache.apply`) and
scored by a loop of calibration-loss forwards, with one host sync per
round (per partition when the search is placed on devices or ranks).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.model import loss_fn
from ..models.transformer import tree_to
from ..robustness import faults
from ..runtime.costmodel import InferenceEnv
from ..runtime.device import (DeviceLike, device_key, resolve_device,
                              synchronize)
from .database import (ModuleDB, SnapshotCache, apply_assignment,
                       build_database)
from .hessian import collect_hessians, resolve_mesh
from .latency import LatencyTable, build_table
from .spdy import SearchResult, search_family
from .structures import registry


@dataclass
class PrunedVariant:
    target_speedup: float
    params: dict
    assignment: Dict[str, int]
    runtime: float
    speedup: float
    calib_loss: float
    search: SearchResult


@dataclass
class OneShotResult:
    variants: Dict[float, PrunedVariant]
    table: LatencyTable
    db: Dict[str, ModuleDB]
    dense_runtime: float
    dense_loss: float
    # host seconds per stage, each ending in a device synchronize
    stage_seconds: Dict[str, float] = field(default_factory=dict)


def calib_loss_fn(cfg, batches, device: DeviceLike = None):
    """params -> mean per-batch calibration loss (a float). The batches
    are moved to ``device`` once; ``fn.tensor`` gives the loss as a
    device scalar without a host sync."""
    dev = resolve_device(device)
    moved = [{k: v.to(dev) for k, v in b.items()} for b in batches]

    @torch.no_grad()
    def loss_tensor(params):
        return torch.stack([loss_fn(cfg, params, b)["loss"]
                            for b in moved]).mean()

    def fn(params) -> float:
        return float(loss_tensor(params))

    fn.tensor = loss_tensor
    return fn


def make_batched_eval(cfg, params, cache: SnapshotCache, batches,
                      device: DeviceLike = None
                      ) -> Callable[[List[Dict[str, int]]], np.ndarray]:
    """Population scorer for `spdy.search_family`: stitch each assignment
    on the device (`SnapshotCache.apply`) and score it with a
    calibration-loss forward; the losses stay on the device until the one
    host sync at the end of the call. Each call hits the
    ``spdy.batched_eval`` fault site first.

    The scorer takes ``device=`` (its ``supports_device`` attribute says
    so) for a placed search: the candidates are then stitched and scored
    on that device, against a replica of the params, the snapshot cache
    and the eval batches built there at first use and kept for the
    scorer's life, one a distinct device (``eval_batched.replicas``;
    tensors already there are shared). A CUDA replica is built on its
    device's default stream, and a call on another stream waits for the
    build's event. ``device=None`` scores on the caller's own params.
    Each candidate is its own forward, so a score does not depend on
    which candidates share the call."""
    loss = calib_loss_fn(cfg, batches, device)
    replicas: Dict[torch.device, tuple] = {}
    lock = threading.Lock()

    def replica(where):
        if where is None:
            return params, cache, loss, None
        d = device_key(where)
        with lock:  # one build a device, whichever thread asks first
            if d not in replicas:
                with torch.cuda.stream(torch.cuda.default_stream(d)
                                       if d.type == "cuda" else None):
                    built = (tree_to(params, d), cache.to_device(d),
                             calib_loss_fn(cfg, batches, d))
                    ready = None
                    if d.type == "cuda":
                        ready = torch.cuda.Event()
                        ready.record()
                replicas[d] = built + (ready,)
        return replicas[d]

    def eval_batched(assignments: List[Dict[str, int]],
                     device: DeviceLike = None) -> np.ndarray:
        faults.hit("spdy.batched_eval")
        p, c, lossd, ready = replica(device)
        if ready is not None:
            torch.cuda.current_stream(device_key(device)).wait_event(ready)
        vals = [lossd.tensor(c.apply(p, a)) for a in assignments]
        # sync: the one host pull per SPDY round (per partition, placed)
        return torch.stack(vals).double().cpu().numpy()

    eval_batched.supports_device = True
    eval_batched.replicas = replicas
    return eval_batched


def oneshot_prune(cfg, params, calib_batches: List[dict],
                  env: InferenceEnv, targets: Sequence[float], *,
                  latency_backend: str = "costmodel",
                  latency_kw: Optional[dict] = None,
                  search_steps: int = 200, search_pop: int = 16,
                  search_batched: bool = True,
                  eval_with_loss: bool = True,
                  eval_batches: Optional[List[dict]] = None,
                  damp: float = 1e-4, seed: int = 0, verbose: bool = False,
                  hessians: Optional[Dict[str, torch.Tensor]] = None,
                  mesh=None, data_axes=None,
                  device: DeviceLike = None) -> OneShotResult:
    """One-shot family pruning on ``device`` (params are moved there).

    ``latency_kw`` is forwarded to ``build_table`` (with ``{"cache_dir":
    ...}`` a measured table is read from, or stored in, the latency
    cache); ``search_pop`` sets the SPDY population per round;
    ``search_batched=False`` runs the serial equivalence-reference search
    (the scalar DP, candidates scored one by one); without
    ``eval_with_loss`` the search scores candidates by the analytic prior
    sum. ``hessians``, the
    ``collect_hessians`` result of these params and batches (say, from a
    run of the other MoE prune mode, whose modules and captures are the
    same), replaces the calibration stage.

    ``mesh``/``data_axes`` (or the installed activation context) shard
    the calibration and the database over the ranks of the mesh. The
    latency table is built on the mesh's first rank and broadcast (a
    measured table differs from build to build), and the loss-scored
    search places each target's candidates on the rank ``k % mesh.size``
    (``spdy.search_family(mesh=)``), so every rank returns the
    single-process result.
    """
    dev = resolve_device(device)
    mesh, data_axes = resolve_mesh(mesh, data_axes)
    params = tree_to(params, dev)
    targets = list(targets)
    stages: Dict[str, float] = {}

    @contextmanager
    def stage(name):
        """Time a stage to its last device op; a profiler sees it as the
        range ``oneshot_prune.<name>``."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"oneshot_prune.{name}"):
            yield
            synchronize(dev)
        stages[name] = time.perf_counter() - t0

    if hessians is None:
        with stage("calibration"):
            hessians = collect_hessians(cfg, params, calib_batches,
                                        mesh=mesh, data_axes=data_axes,
                                        device=dev)
    with stage("latency_table"):
        table = None
        if mesh is None or mesh.index() == 0:
            table = build_table(cfg, env, backend=latency_backend,
                                device=dev, **(latency_kw or {}))
        if mesh is not None:
            table = mesh.broadcast_object(table)
    with stage("database"):
        db = build_database(cfg, params, hessians, damp=damp,
                            verbose=verbose, mesh=mesh,
                            shard_axes=data_axes, device=dev)
        del hessians
    with stage("search"):
        cache = SnapshotCache(cfg, db, device=dev) if eval_with_loss else None
        mods = registry(cfg)
        dense_rt = table.dense_runtime(mods)
        evals = eval_batches or calib_batches[:1]
        loss_eval = calib_loss_fn(cfg, evals, device=dev)
        dense_loss = loss_eval(params)
        eval_fn = eval_batched = None
        if eval_with_loss:
            def eval_fn(assignment):
                return loss_eval(cache.apply(params, assignment))
            eval_batched = make_batched_eval(cfg, params, cache, evals,
                                             device=dev)
        results = search_family(db, table, targets, steps=search_steps,
                                pop=search_pop, eval_fn=eval_fn,
                                eval_batched=eval_batched, seed=seed,
                                batched=search_batched, mesh=mesh,
                                verbose=verbose)

    variants: Dict[float, PrunedVariant] = {}
    with stage("stitch"):
        for t in targets:
            res = results[t]
            pruned = apply_assignment(cfg, params, db, res.assignment,
                                      cache=cache)
            variants[t] = PrunedVariant(
                target_speedup=t, params=pruned, assignment=res.assignment,
                runtime=res.runtime, speedup=res.speedup,
                calib_loss=loss_eval(pruned), search=res)
            if verbose:
                print(f"target {t}x -> achieved {res.speedup:.2f}x, "
                      f"loss {variants[t].calib_loss:.4f} "
                      f"(dense {dense_loss:.4f})")
    return OneShotResult(variants=variants, table=table, db=db,
                         dense_runtime=dense_rt, dense_loss=dense_loss,
                         stage_seconds=stages)
