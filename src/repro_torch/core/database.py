"""Per-layer pruning database (paper §3.2): for every prunable module, the
ZipLM-updated weight snapshot, squared error and SPDY prior at each
sparsity level, from a single Algorithm-1 run per module.

Construction is batched: modules with identical ``(group_size,
n_structures, d_out, levels)`` signature — all attention layers, all FFN
layers — run Algorithm 1 as one stack (``obs.prune_structured_batched``),
one fused downdate launch per step for the whole stack. ``batched=False``
keeps the serial per-module path as the equivalence reference.
``compact=True`` runs either route through the live-set-compacted cores
(``obs.prune_structured[_batched]_compact``): the same removal orders,
snapshots in the same layout, a downdate that shrinks with the live set.

``mesh`` shards each chunk over the ranks of its ``shard_axes``
(``obs.prune_structured_sharded``): each rank runs its block of lanes,
the damping ladder climbs on all ranks together, and each rank fetches
its block and all-gathers the others', so every rank holds the
single-process database bit for bit. The ``db.sharded_group`` fault site
demotes a chunk to the single-process build on every rank.

``SnapshotCache`` keeps the stacked snapshots on the device so SPDY's
per-candidate stitch is one gather + scatter per module kind; a per-expert
kind (MoE) writes ``leaf[layer, expert]``.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import axis_size, data_axes_for
from ..robustness import faults
from ..robustness.healing import damp_schedule
from ..robustness.report import current_report
from ..runtime.device import (DeviceLike, resolve_device, synchronize,
                              to_host)
from .obs import (build_hessian, gather_lanes, module_drop_error,
                  module_drop_errors, prune_structured,
                  prune_structured_batched, prune_structured_batched_compact,
                  prune_structured_compact, prune_structured_sharded,
                  shard_lanes)
from .structures import (UNITS, PrunableModule, copy_tree, get_matrix,
                         level_grid, registry, set_matrix)

# the snapshots' round trip through host memory: bytes and seconds of the
# database's fetch of each chunk's float16 snapshots (timed from a
# synchronize, so Algorithm 1's queued work is not counted) and of
# SnapshotCache's upload; a caller zeroes it with reset_snapshot_traffic
SNAPSHOT_TRAFFIC = {"fetch_bytes": 0, "fetch_s": 0.0,
                    "upload_bytes": 0, "upload_s": 0.0}


def reset_snapshot_traffic() -> None:
    SNAPSHOT_TRAFFIC.update(fetch_bytes=0, fetch_s=0.0, upload_bytes=0,
                            upload_s=0.0)


def _inverse_or_nan(h: torch.Tensor) -> torch.Tensor:
    """fp32 inverse of fp32 ``h``, NaN where a matrix is singular (as the
    reference's is), so the damping ladder can retry instead of the loop
    raising. The inverse is taken in fp64 and rounded once: Algorithm 1
    carries Hinv through thousands of downdates, and an fp32 LU inverse
    of a calibration Hessian (condition numbers of 1e4 and more) is off
    by cond * eps before the first step."""
    inv, info = torch.linalg.inv_ex(h.double())
    inv = inv.float().contiguous()  # linalg may return column-major
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(inv, float("nan")), inv)


def _finite_snapshots(snaps: torch.Tensor, n_mods: int,
                      n_levels: int) -> np.ndarray:
    """(modules, levels) bools, whether each float16 snapshot is entirely
    finite, reduced where the snapshots are, one level at a time: at full
    width the stack is tens of GB, too much for one boolean temporary on
    the card or for a pass of numpy's float16 ``isfinite`` on the host."""
    s = snaps.reshape(n_mods, n_levels, -1)
    return torch.stack([torch.isfinite(s[:, i]).all(-1)
                        for i in range(n_levels)], 1).cpu().numpy()


def _non_finite_report(names, levels, errs, snap_ok) -> List[str]:
    """Per module whose prune went non-finite: its name and the first
    level whose cumulative error, or float16 snapshot, is not finite (the
    error stays non-finite once it is, so the step that failed lies
    between the level before and that level). ``snap_ok`` is
    :func:`_finite_snapshots` of the snapshots."""
    errs = errs.reshape(len(names), len(levels))
    bad_err = ~np.isfinite(errs)
    bad_snap = ~snap_ok
    out = []
    for m, name in enumerate(names):
        what = []
        for label, bad in (("error", bad_err[m]), ("float16 snapshot",
                                                   bad_snap[m])):
            if bad.any():
                i = int(np.argmax(bad))
                lo, hi = (levels[i - 1] + 1 if i else 0), levels[i]
                step = (f"removal {hi}" if lo == hi
                        else f"one of removals {lo}..{hi}")
                what.append(f"{label} from level {hi} ({step})")
        if what:
            out.append(f"{name} " + ", ".join(what))
    return out


def _prune_healed(prune_fn, Ws, Hraw, *, group_size, n_remove, levels,
                  damp, names, shard=None):
    """Run Algorithm 1, climbing the damping ladder while the result is
    non-finite; returns host arrays ``(snaps16, errs, orders)``.

    ``shard``, a (mesh, axes) pair, makes ``prune_fn`` the sharded prune:
    every rank inverts the whole chunk's Hessians, as the single-process
    build does (on the card a lane's fp64 inverse takes other bits in a
    batch of another size), and prunes its block; each rank checks its
    own block, a rung fails on every rank if it fails on any (one
    all-reduce a rung, so the ranks climb together as the single-process
    build re-runs its finite lanes with the others), and the fetched
    blocks are all-gathered.

    Rung 0 is the caller's damp, so a run that never escalates is the
    un-healed computation; the snapshots are checked on their device and
    fetched only when the rung is finite. Each failed rung names the
    modules that failed and where, and counts as detected and retried at
    ``obs.cholesky`` in the ambient report (a healed chunk as recovered);
    that fault site poisons the inverse Hessian of one rung.
    """
    rep = current_report()
    rungs = damp_schedule(damp)
    n = len(names)
    if shard is not None:  # the names of this rank's block
        mesh, axes = shard
        pad = (-n) % axis_size(mesh, axes)
        names = (list(names) + [names[0]] * pad)[
            shard_lanes(mesh, axes, n)]
    for attempt, rung in enumerate(rungs):
        Hinv = faults.poison_array(
            "obs.cholesky", _inverse_or_nan(build_hessian(Hraw, rung)))
        res = prune_fn(Ws, Hinv, group_size=group_size, n_remove=n_remove,
                       levels=levels)
        errs = res.errors.cpu().numpy()
        snap_ok = _finite_snapshots(res.snapshots, len(names), len(levels))
        bad = _non_finite_report(names, levels, errs, snap_ok)
        failed = bool(bad) if shard is None else mesh.any(bool(bad), axes)
        if not failed:
            if attempt:
                rep.count("recovered", "obs.cholesky")
                print(f"[robustness] obs: healed non-finite prune at "
                      f"damp={rung:g} (rung {attempt})")
            # sync: DB materialization — fetched once per chunk
            synchronize(res.snapshots.device)
            t0 = time.perf_counter()
            snaps16 = to_host(res.snapshots)
            SNAPSHOT_TRAFFIC["fetch_s"] += time.perf_counter() - t0
            SNAPSHOT_TRAFFIC["fetch_bytes"] += snaps16.nbytes
            out = snaps16, errs, res.order.cpu().numpy()
            return out if shard is None else gather_lanes(mesh, axes, n,
                                                          *out)
        rep.count("detected", "obs.cholesky")
        rep.count("retries", "obs.cholesky")
        print(f"[robustness] obs: non-finite prune at damp={rung:g} in "
              f"{len(bad)} of {len(names)} module(s)"
              + (": " + "; ".join(bad) if bad else " here, on another rank"))
    raise FloatingPointError(
        f"OBS prune stayed non-finite through the damping ladder {rungs} "
        "— calibration Hessian is unusable")


@dataclass
class ModuleDB:
    mod: PrunableModule
    levels: np.ndarray       # structures removed, ascending; last = full drop
    snapshots: np.ndarray    # (n_levels, d_in, d_out) float16 (host)
    errors: np.ndarray       # cumulative sq. error per level (raw-H scale)
    priors: np.ndarray       # p_s in [0, 1]; 1.0 = module dropped
    base_norm: float
    order: np.ndarray = None  # structure removed at step i

    def weights_at(self, removed: int) -> np.ndarray:
        i = int(np.searchsorted(self.levels, removed))
        return self.snapshots[i]

    def kept_structures(self, removed: int) -> np.ndarray:
        """Sorted indices of structures remaining at a level."""
        gone = set(np.asarray(self.order[:removed]).tolist())
        return np.asarray([g for g in range(self.mod.n_structures)
                           if g not in gone])


def _finish_module_db(mod: PrunableModule, levels: np.ndarray,
                      snapshots16: np.ndarray, errors_raw: np.ndarray,
                      base: float, order: np.ndarray) -> ModuleDB:
    """Host-side post-processing shared by the serial and batched paths."""
    errs = np.asarray(errors_raw, np.float64) / 2.0  # H had the paper's 2x
    errs[-1] = base if levels[-1] == mod.n_structures else errs[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        priors = np.sqrt(np.maximum(errs, 0.0) / max(base, 1e-30))
    priors = np.clip(np.nan_to_num(priors, nan=1.0), 0.0, 1.0)
    return ModuleDB(mod=mod, levels=np.asarray(levels),
                    snapshots=np.asarray(snapshots16, np.float16),
                    errors=errs, priors=priors, base_norm=base,
                    order=np.asarray(order))


def build_module_db(cfg, params, mod: PrunableModule, h_raw,
                    damp: float = 1e-4, compact: bool = False) -> ModuleDB:
    W = get_matrix(cfg, params, mod).float()
    h_raw = h_raw.to(W.device, torch.float32)
    levels = level_grid(mod)
    prune = prune_structured_compact if compact else prune_structured
    snaps16, errs, orders = _prune_healed(
        prune, W, h_raw, group_size=mod.group_size,
        n_remove=max(levels), levels=tuple(levels), damp=damp,
        names=[mod.name])
    base = float(module_drop_error(W, h_raw))
    return _finish_module_db(mod, np.asarray(levels), snaps16, errs,
                             base, orders)


def group_modules(cfg, params, mods: List[PrunableModule]
                  ) -> List[Tuple[tuple, List[PrunableModule]]]:
    """Group modules whose Algorithm-1 runs share one signature:
    identical (group_size, n_structures, d_out, levels)."""
    groups: Dict[tuple, List[PrunableModule]] = {}
    for mod in mods:
        d_out = get_matrix(cfg, params, mod).shape[1]
        key = (mod.group_size, mod.n_structures, d_out,
               tuple(level_grid(mod)))
        groups.setdefault(key, []).append(mod)
    return list(groups.items())


def _shard_or_demote(rep, mesh, axes):
    """The ``db.sharded_group`` site, hit once a chunk: (mesh, axes) to
    shard the chunk, or None (the breaker tripped) when a fault injected
    at the site fired on any rank."""
    why = "a fault injected on another rank"
    try:
        faults.hit("db.sharded_group")
        fired = False
    except faults.INJECTED as e:
        fired, why = True, repr(e)
    if mesh.any(fired, axes):
        rep.trip("db.sharded_group", reason=f"sharded db chunk: {why}")
        return None
    return mesh, axes


def build_database(cfg, params, hessians: Dict[str, torch.Tensor], *,
                   damp: float = 1e-4, verbose: bool = False,
                   batched: bool = True, compact: bool = False,
                   max_batch: int = 16, mesh=None, shard_axes=None,
                   device: DeviceLike = None) -> Dict[str, ModuleDB]:
    """The database of every registry module, built on ``device``
    (``params`` must live there; Hessians are moved to it).

    ``max_batch`` bounds how many modules of one shape group run as one
    stack, capping device memory at max_batch x (Hinv + snapshot stack).
    ``compact=True`` routes Algorithm 1 through the live-set-compacted
    cores: the same orders, the snapshots scattered back to the original
    rows before ``_finish_module_db``.

    ``mesh`` (with more than one shard over ``shard_axes``, by default
    the mesh's data axes) shards each chunk over the ranks; every rank
    returns the single-process database bit for bit. A fault injected at
    ``db.sharded_group`` (hit once a chunk) demotes that chunk, and every
    later one under the ambient report, to the single-process build on
    every rank: the ranks share the decision (one all-reduce) before the
    chunk's first collective, and the breaker trips once a report. Any
    other error raises: unlike the reference, which demotes on every
    exception.
    """
    dev = resolve_device(device)
    mods = registry(cfg)
    db: Dict[str, ModuleDB] = {}
    rep = current_report()
    if mesh is not None and shard_axes is None:
        shard_axes = data_axes_for(mesh)
    n_shards = axis_size(mesh, shard_axes) if mesh is not None else 1
    with torch.no_grad():
        if not batched:
            for mod in mods:
                db[mod.name] = build_module_db(cfg, params, mod,
                                               hessians[mod.name], damp,
                                               compact=compact)
        else:
            prune_batched = (prune_structured_batched_compact if compact
                             else prune_structured_batched)
            for key, gmods in group_modules(cfg, params, mods):
                gs, _, _, levels = key
                for lo in range(0, len(gmods), max_batch):
                    chunk = gmods[lo:lo + max_batch]
                    Ws = torch.stack([get_matrix(cfg, params, m).float()
                                      for m in chunk]).to(dev)
                    Hraw = torch.stack([hessians[m.name].float()
                                        for m in chunk]).to(dev)
                    shard = None
                    if n_shards > 1 and not rep.breaker_open(
                            "db.sharded_group"):
                        shard = _shard_or_demote(rep, mesh, shard_axes)
                    prune = prune_batched if shard is None else \
                        functools.partial(prune_structured_sharded,
                                          mesh=mesh, axes=shard_axes,
                                          compact=compact)
                    snaps16, errs, orders = _prune_healed(
                        prune, Ws, Hraw, group_size=gs,
                        n_remove=max(levels), levels=levels, damp=damp,
                        names=[m.name for m in chunk], shard=shard)
                    # sync: one transfer per chunk
                    bases = module_drop_errors(Ws, Hraw).double().cpu().numpy()
                    lv = np.asarray(levels)
                    for i, m in enumerate(chunk):
                        db[m.name] = _finish_module_db(
                            m, lv, snaps16[i], errs[i], float(bases[i]),
                            orders[i])
            db = {m.name: db[m.name] for m in mods}  # registry order
    if verbose:
        for name, mdb in db.items():
            p = mdb.priors
            print(f"  db {name}: levels={len(p)} "
                  f"p[1]={p[min(1, len(p)-1)]:.4f} p[-2]={p[-2]:.4f}")
    return db


# ----------------------------------------------------------------------
# device-resident snapshot cache for SPDY evaluation
# ----------------------------------------------------------------------

class SnapshotCache:
    """Device-resident stacked database snapshots.

    Built once from a database; ``apply`` assembles any level assignment
    as one gather + scatter per (kind, level grid), entirely on the
    device that holds the params.
    """

    def __init__(self, cfg, db: Dict[str, ModuleDB], device: DeviceLike = None):
        dev = resolve_device(device)
        # modules stack per (kind, level grid): a shared searchsorted over
        # the wrong grid would stitch the wrong snapshot index
        by_key: Dict[tuple, List[ModuleDB]] = {}
        for mdb in db.values():
            key = (mdb.mod.kind, tuple(np.asarray(mdb.levels).tolist()))
            by_key.setdefault(key, []).append(mdb)
        self._groups = [{
            "kind": kind,
            "names": [m.mod.name for m in mdbs],
            "levels": np.asarray(levels),
            # the leaf index of each module: (layer,) or (layer, expert)
            "index": self._leaf_index(kind, mdbs, dev),
            "snaps": self._upload([m.snapshots for m in mdbs], dev),
        } for (kind, levels), mdbs in by_key.items()]

    @staticmethod
    def _leaf_index(kind, mdbs, dev):
        idx = [torch.tensor([m.mod.layer for m in mdbs], device=dev)]
        if UNITS[kind].per_expert:
            idx.append(torch.tensor([m.mod.expert for m in mdbs], device=dev))
        return tuple(idx)

    @staticmethod
    def _upload(snapshots: List[np.ndarray], dev) -> torch.Tensor:
        """(M, n_levels, d_in, d_out) float16 on ``dev``, uploaded once,
        module by module (no second stacked copy in host memory)."""
        t0 = time.perf_counter()
        out = torch.empty((len(snapshots),) + snapshots[0].shape,
                          dtype=torch.float16, device=dev)
        for i, snap in enumerate(snapshots):
            out[i].copy_(torch.from_numpy(snap))
        synchronize(dev)
        SNAPSHOT_TRAFFIC["upload_s"] += time.perf_counter() - t0
        SNAPSHOT_TRAFFIC["upload_bytes"] += out.numel() * out.element_size()
        return out

    def to_device(self, device: DeviceLike) -> "SnapshotCache":
        """This cache on ``device``: the snapshots and leaf indices copied
        there (shared where they already are)."""
        dev = resolve_device(device)
        out = object.__new__(SnapshotCache)
        out._groups = [{**e, "index": tuple(i.to(dev) for i in e["index"]),
                        "snaps": e["snaps"].to(dev)} for e in self._groups]
        return out

    def covers(self, assignment: Dict[str, int]) -> bool:
        return all(n in assignment for e in self._groups for n in e["names"])

    def _level_index(self, e, assignments: Sequence[Dict[str, int]]):
        lvl = np.asarray([[a[n] for n in e["names"]] for a in assignments])
        idx = np.searchsorted(e["levels"], lvl)
        return torch.from_numpy(idx).to(e["snaps"].device)   # (P, M)

    def apply(self, params, assignment: Dict[str, int]):
        """Params with the assignment's snapshots stitched in (a new
        tree; the given one is not written)."""
        new = copy_tree(params)
        layers = new["layers"]
        for e in self._groups:
            lvl_idx = self._level_index(e, [assignment])[0]
            grp, key = UNITS[e["kind"]].param_path
            leaf = layers[grp][key].clone()
            m = torch.arange(len(e["names"]), device=leaf.device)
            leaf[e["index"]] = e["snaps"][m, lvl_idx].to(leaf.dtype)
            layers[grp][key] = leaf
        return new

    def apply_batched(self, params, assignments: Sequence[Dict[str, int]]):
        """Stitch P assignments into one tree whose stitched leaves gain a
        leading (P,) axis; every other leaf is the original tensor.

        The counterpart of the reference's ``apply_batched``, for a caller
        that runs all P members in one batched forward. The port's own
        population scorer (``oneshot.make_batched_eval``) runs one forward
        per member, so it stitches with ``apply`` and never holds P
        copies of a leaf."""
        new = copy_tree(params)
        layers = new["layers"]
        P = len(assignments)
        stacked = set()
        for e in self._groups:
            lvl_idx = self._level_index(e, assignments)          # (P, M)
            grp, key = UNITS[e["kind"]].param_path
            leaf = layers[grp][key]
            if (grp, key) not in stacked:
                leaf = leaf.unsqueeze(0).repeat(P, *([1] * leaf.ndim))
                stacked.add((grp, key))
            m = torch.arange(len(e["names"]), device=leaf.device)
            leaf[(slice(None),) + e["index"]] = \
                e["snaps"][m[None, :], lvl_idx].to(leaf.dtype)
            layers[grp][key] = leaf
        return new


def apply_assignment(cfg, params, db: Dict[str, ModuleDB],
                     assignment: Dict[str, int],
                     cache: Optional[SnapshotCache] = None):
    """Stitch the database snapshots for a per-module level assignment
    into the params (the masked model). With a SnapshotCache the stitch
    is a device-side gather; without one, per-module host uploads."""
    if cache is not None and cache.covers(assignment):
        return cache.apply(params, assignment)
    new = params
    for name, removed in assignment.items():
        mdb = db[name]
        w = torch.from_numpy(mdb.weights_at(removed)).float()
        new = set_matrix(cfg, new, mdb.mod, w)
    return new
