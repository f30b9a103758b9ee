"""Structured SPDY search (paper §3.2) — population-batched engine.

Finds the per-module sparsity-level assignment that meets a runtime budget
while minimizing (sensitivity-weighted) layer-wise error:

* prior p_s = relative layer-wise error ||W_s X - W X|| / ||W X|| (value 1
  for a fully dropped module);
* fixed mutation budget, each step mutating ~10% of the per-module
  sensitivity coefficients;
* every DP candidate achieves the runtime budget by construction (times
  are ceil-quantized into bins), giving the speedup guarantee.

The search runs in rounds of ``pop`` candidates per target: all
candidates of a round are mutated from the round-start coefficients,
solved with one vectorized DP pass (`dp_select_batched`), deduplicated
against a score memo, and the surviving unique assignments of the whole
family are scored in one ``eval_batched`` call (one host sync per round).
Any scored candidate whose true table runtime meets another target's
budget is harvested for that target. Per-target RNG streams are spawned
from ``seed``. ``batched=False`` runs the same rounds, mutations and
acceptance with the scalar `dp_select` and per-candidate ``eval_fn``:
the equivalence reference (for the analytic score, bit-identical
results). Host-side numpy throughout; the same seed gives the same
candidates as the JAX package's engine.

Placement: each new key of a round is recorded with the first target
that produced it, and the round's keys fall into one partition per
producing target. ``devices`` (more than one, with a scorer whose
``supports_device`` attribute is true) scores partition ``k`` on
``devices[k % len(devices)]``, one thread a partition; each list
position runs its partitions on a CUDA stream of its own, so that a list
may name one card twice. ``mesh`` is the port's form over the ranks of a
``distributed.Mesh``: the JAX package places over ``mesh.devices.flat``
in one process, while the port runs one process a rank, so rank ``r``
scores the partitions with ``k % mesh.size == r`` on its own device and
the ranks exchange the scores through one ``Mesh.all_gather`` a round
(a full-length float64 row a rank, each index read from its owner's
row). A candidate's score does not depend on which others share its
call, so placed and unplaced searches give the same bits, and every rank
holds the same memo. ``PLACED_SCORING`` counts what this process's
placed scoring did.

Degradation: when the batched scorer, or any partition of a placed
round on any thread or rank, fails with a fault injected at
``spdy.batched_eval`` or a CUDA out-of-memory error, the
``spdy.batched_eval`` breaker of the ambient report opens and that round
and every later one score serially and unplaced (``eval_fn``), with the
same memo and acceptances. On a mesh the ranks share that decision with
one ``Mesh.any`` before the round's all-gather, so every rank demotes
and only the faulting one counts an injection. Any other failure raises.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..robustness.healing import demotable
from ..robustness.report import current_report
from ..runtime.device import join_streams, placement_streams
from .database import ModuleDB
from .latency import LatencyTable

SeedLike = Union[int, np.random.SeedSequence]
SITE = "spdy.batched_eval"

# what this process's placed scoring did: scorer calls (one a
# partition), candidates scored by producing target, and mesh
# all-gathers; a caller zeroes it with reset_placed_scoring
PLACED_SCORING = {"calls": 0, "scored": {}, "all_gathers": 0}


def reset_placed_scoring() -> None:
    PLACED_SCORING.update(calls=0, scored={}, all_gathers=0)


@dataclass
class SearchResult:
    assignment: Dict[str, int]
    runtime: float
    speedup: float
    score: float
    coeffs: np.ndarray
    history: List[float] = field(default_factory=list)
    n_evals: int = 0          # unique assignments actually scored (family-wide)


def quantize_times(times: List[np.ndarray], budget: float,
                   nbins: int = 1024) -> List[np.ndarray]:
    """Ceil-quantize per-module level times into ``nbins`` budget bins.

    Done once per (budget, nbins): the mutation population only rescales
    costs, never times, so every DP call for a target shares this.
    """
    scale = budget / nbins if budget > 0 else 1.0
    return [np.minimum(np.ceil(t / scale).astype(np.int64), nbins + 1)
            for t in times]


def dp_select(costs: List[np.ndarray], times: List[np.ndarray],
              budget: float, nbins: int = 1024,
              tq: Optional[List[np.ndarray]] = None):
    """Pick one level per module minimizing sum(cost) s.t. sum(time) <=
    budget. Returns ``(choices, total_cost)``, or ``(None, inf)`` when
    infeasible; the scalar reference of `dp_select_batched`. Pass
    pre-quantized ``tq`` to skip quantizing again."""
    m = len(costs)
    if tq is None:
        tq = quantize_times(times, budget, nbins)

    INF = np.inf
    dp = np.full(nbins + 1, INF)
    dp[0] = 0.0
    choice = np.zeros((m, nbins + 1), np.int16)
    for i in range(m):
        best = np.full(nbins + 1, INF)
        arg = np.zeros(nbins + 1, np.int16)
        for l in range(len(costs[i])):
            t = int(tq[i][l])
            if t > nbins:
                continue
            cand = np.full(nbins + 1, INF)
            if t == 0:
                cand = dp + costs[i][l]
            else:
                cand[t:] = dp[:-t] + costs[i][l]
            upd = cand < best
            best[upd] = cand[upd]
            arg[upd] = l
        dp = best
        choice[i] = arg
    b = int(np.argmin(dp))
    if not np.isfinite(dp[b]):
        return None, np.inf
    total = float(dp[b])
    choices = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        l = int(choice[i, b])
        choices[i] = l
        b -= int(tq[i][l])
    return choices, total


def dp_select_batched(costs: List[np.ndarray], times=None, budget=None,
                      nbins: int = 1024, tq: Optional[List[np.ndarray]] = None):
    """Pick one level per module minimizing sum(cost) s.t. sum(time) <=
    budget, for a ``(P,)`` candidate batch at once.

    ``costs``: one ``(P, n_levels_i)`` array per module. Times are shared
    by the batch: pass pre-quantized ``tq`` (from `quantize_times`) or
    ``times`` + ``budget``. Returns ``(choices (P, m), totals (P,))``
    with rows of -1 (and inf) for infeasible candidates.
    """
    m = len(costs)
    P = int(costs[0].shape[0])
    if tq is None:
        tq = quantize_times(times, budget, nbins)

    INF = np.inf
    dp = np.full((P, nbins + 1), INF)
    dp[:, 0] = 0.0
    choice = np.zeros((m, P, nbins + 1), np.int16)
    for i in range(m):
        best = np.full((P, nbins + 1), INF)
        arg = np.zeros((P, nbins + 1), np.int16)
        ci = costs[i]
        for l in range(ci.shape[1]):
            t = int(tq[i][l])
            if t > nbins:
                continue
            # update only the reachable [t:] tail in place
            cand = (dp + ci[:, l:l + 1] if t == 0
                    else dp[:, :-t] + ci[:, l:l + 1])
            bs = best if t == 0 else best[:, t:]
            upd = cand < bs
            np.copyto(bs, cand, where=upd)
            np.copyto(arg if t == 0 else arg[:, t:], np.int16(l),
                      where=upd)
        dp = best
        choice[i] = arg
    rows = np.arange(P)
    b = np.argmin(dp, axis=1)
    totals = dp[rows, b]
    infeasible = ~np.isfinite(totals)
    choices = np.full((P, m), -1, np.int64)
    if infeasible.all():
        return choices, totals
    bb = b.astype(np.int64)
    for i in range(m - 1, -1, -1):
        l = choice[i, rows, bb].astype(np.int64)
        choices[:, i] = l
        # feasible rows stay in range by DP construction; clamp so rows
        # being discarded as infeasible cannot index out of bounds
        bb = np.clip(bb - tq[i][l], 0, nbins)
    choices[infeasible] = -1
    return choices, totals


def _partitions(new_from: List[int]) -> List[Tuple[int, List[int]]]:
    """A round's new keys by first-producing target: ``(k, indices)``
    pairs, ``k`` ascending."""
    parts: Dict[int, List[int]] = {}
    for i, k in enumerate(new_from):
        parts.setdefault(k, []).append(i)
    return sorted(parts.items())


def _count_placed(parts) -> None:
    PLACED_SCORING["calls"] += len(parts)
    scored = PLACED_SCORING["scored"]
    for k, idxs in parts:
        scored[k] = scored.get(k, 0) + len(idxs)


def _eval_placed(eval_batched, assemble, new_keys: List[tuple],
                 new_from: List[int], devices) -> np.ndarray:
    """One round's scoring placed on ``devices``: the partition of target
    ``k`` is scored by one call on ``devices[k % len(devices)]``, one
    thread a partition, under that list position's stream; the scores
    are gathered into one float64 array. When partitions fail, one that
    is not demotable is raised first."""
    parts = _partitions(new_from)
    streams = placement_streams(devices)

    def run(k, idxs):
        pos = k % len(devices)
        with torch.cuda.stream(streams[pos]):
            return eval_batched([assemble(new_keys[i]) for i in idxs],
                                device=devices[pos])

    with ThreadPoolExecutor(max_workers=len(parts)) as ex:
        futures = [ex.submit(run, k, idxs) for k, idxs in parts]
    join_streams(streams)
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:
        raise next((e for e in errors if not demotable(e, SITE)), errors[0])
    vals = np.empty((len(new_keys),), np.float64)
    for (_, idxs), f in zip(parts, futures):
        vals[idxs] = np.asarray(f.result(), np.float64)
    _count_placed(parts)
    return vals


def _eval_on_ranks(eval_batched, assemble, new_keys: List[tuple],
                   new_from: List[int], mesh, rep) -> Optional[np.ndarray]:
    """The mesh form of `_eval_placed`: this rank scores the partitions
    of the targets ``k`` with ``k % mesh.size == mesh.index()``, one call
    each on its own device. One ``Mesh.any`` shares a failure (then every
    rank trips the breaker and None is returned), one ``Mesh.all_gather``
    the scores. Every rank calls both, whether it owns a partition or
    not."""
    n, me = mesh.size, mesh.index()
    parts = [(k, idxs) for k, idxs in _partitions(new_from) if k % n == me]
    row = np.zeros((len(new_keys),), np.float64)
    failed = rep.breaker_open(SITE)
    why = "a failure on another rank"
    if not failed:
        try:
            for k, idxs in parts:
                row[idxs] = np.asarray(eval_batched(
                    [assemble(new_keys[i]) for i in idxs]), np.float64)
        except Exception as e:
            if not demotable(e, SITE):
                raise
            failed, why = True, repr(e)
    if mesh.any(failed):
        rep.trip(SITE, reason=f"placed scoring failed: {why}")
        return None
    rows = mesh.all_gather(row[None, :])
    _count_placed(parts)
    PLACED_SCORING["all_gathers"] += 1
    return rows[np.asarray(new_from) % n, np.arange(len(new_keys))]


def _spawn_rngs(seed: SeedLike, n: int) -> List[np.random.Generator]:
    """Mutually independent per-target RNG streams."""
    root = (seed if isinstance(seed, np.random.SeedSequence)
            else np.random.SeedSequence(seed))
    return [np.random.default_rng(c) for c in root.spawn(n)]


def _mutate_population(rng: np.random.Generator, coeffs: np.ndarray,
                       pop: int, mutate_frac: float,
                       include_base: bool) -> np.ndarray:
    """A round's candidate coefficients — (pop, m), row 0 the unmutated
    base when ``include_base`` (round 0)."""
    m = len(coeffs)
    out = np.empty((pop, m))
    for p in range(pop):
        if include_base and p == 0:
            out[p] = coeffs
            continue
        c = coeffs.copy()
        mask = rng.random(m) < mutate_frac
        if not mask.any():
            mask[rng.integers(m)] = True
        c[mask] *= np.exp(rng.normal(0, 0.6, mask.sum()))
        out[p] = c
    return out


def search_family(db: Dict[str, ModuleDB], table: LatencyTable,
                  targets: Sequence[float], *, steps: int = 1000,
                  pop: int = 16, mutate_frac: float = 0.1,
                  nbins: int = 1024,
                  eval_fn: Optional[Callable[[Dict[str, int]], float]] = None,
                  eval_batched: Optional[
                      Callable[[List[Dict[str, int]]], np.ndarray]] = None,
                  seed: SeedLike = 0, batched: bool = True,
                  share_pool: bool = True, devices=None, mesh=None,
                  verbose: bool = False) -> Dict[float, SearchResult]:
    """One amortized SPDY search over a whole speedup-target family.

    ``steps`` counts candidates per target. ``eval_batched`` scores a list
    of assignments in one call (see ``oneshot.make_batched_eval``); the
    batched path without it, and ``batched=False`` always, score the
    round's new candidates one by one with ``eval_fn`` (or
    ``eval_batched`` of one). With neither, candidates get the paper's
    analytic sum-of-squared-priors score.

    ``devices`` (more than one, with a scorer that ``supports_device``)
    places each target's new candidates on its own device, and ``mesh``
    (more than one rank) on its own rank; the batched scorer's rounds
    only (see the module docstring). Either gives every target the
    unplaced search's result bit for bit.
    """
    if devices is not None and mesh is not None:
        raise ValueError("search_family places on devices= (one process) "
                         "or on mesh= (one process a rank), not both")
    targets = list(targets)
    K = len(targets)
    if K == 0:
        return {}
    if pop <= 0:
        raise ValueError(f"pop must be positive, got {pop}")
    names = list(db.keys())
    m = len(names)
    priors = [db[n].priors.astype(np.float64) for n in names]
    times = [table.level_times(db[n].mod).astype(np.float64) for n in names]
    dense = table.base + sum(t[0] for t in times)

    budgets = []
    for t in targets:
        budget = dense / t - table.base
        if budget <= 0:
            raise ValueError(
                f"target speedup {t}x below the unprunable base "
                f"({table.base:.2e}s of {dense:.2e}s dense)")
        budgets.append(budget)
    tqs = [quantize_times(times, b, nbins) for b in budgets]

    def assemble(choices) -> Dict[str, int]:
        return {n: int(db[n].levels[c]) for n, c in zip(names, choices)}

    def runtime(choices) -> float:
        return table.base + sum(t[c] for t, c in zip(times, choices))

    rngs = _spawn_rngs(seed, K)
    coeffs = [np.ones(m) for _ in range(K)]
    best: List[Optional[SearchResult]] = [None] * K
    harvested: List[Optional[SearchResult]] = [None] * K
    hist: List[List[float]] = [[] for _ in range(K)]
    done = [0] * K
    memo: Dict[tuple, float] = {}
    producer: Dict[tuple, np.ndarray] = {}  # choices-tuple -> coeffs row
    n_evals = 0
    analytic = eval_fn is None and eval_batched is None
    rep = current_report()
    placed = (devices is not None and len(devices) > 1
              and getattr(eval_batched, "supports_device", False))
    ranks = mesh if mesh is not None and mesh.size > 1 else None

    rnd = 0
    while any(d < steps for d in done):
        entries = []  # (k, C, choices) per target active this round
        for k in range(K):
            P_k = min(pop, steps - done[k])
            if P_k <= 0:
                continue
            C = _mutate_population(rngs[k], coeffs[k], P_k, mutate_frac,
                                   include_base=(rnd == 0))
            done[k] += P_k
            if batched:
                costs = [C[:, [i]] * priors[i][None, :] for i in range(m)]
                ch, _ = dp_select_batched(costs, tq=tqs[k], nbins=nbins)
            else:
                ch = np.full((P_k, m), -1, np.int64)
                for p in range(P_k):
                    cp = [C[p, i] * priors[i] for i in range(m)]
                    c_p, _ = dp_select(cp, times, budgets[k], nbins,
                                       tq=tqs[k])
                    if c_p is not None:
                        ch[p] = c_p
            entries.append((k, C, ch))

        # dedup this round's feasible candidates against the shared memo
        new_keys: List[tuple] = []
        new_from: List[int] = []  # the first target producing each new key
        for k, C, ch in entries:
            for p in range(ch.shape[0]):
                if ch[p, 0] < 0:
                    continue
                key = tuple(int(c) for c in ch[p])
                if key not in memo and key not in producer:
                    producer[key] = C[p].copy()
                    new_keys.append(key)
                    new_from.append(k)

        if new_keys:
            if analytic:
                vals = [float(sum(p[c] ** 2 for p, c in zip(priors, key)))
                        for key in new_keys]
            else:
                vals = None
                if batched and eval_batched is not None and ranks is not None:
                    # the mesh shares its demotion: None on every rank
                    vals = _eval_on_ranks(eval_batched, assemble, new_keys,
                                          new_from, ranks, rep)
                elif (batched and eval_batched is not None
                        and not rep.breaker_open(SITE)):
                    try:
                        vals = (_eval_placed(eval_batched, assemble,
                                             new_keys, new_from, devices)
                                if placed else np.asarray(eval_batched(
                                    [assemble(key) for key in new_keys]),
                                    np.float64))
                    except Exception as e:
                        if not demotable(e, SITE):
                            raise
                        # the degradation rung: this round and every later
                        # one score serially and unplaced, with the same
                        # memo and the same acceptance stream
                        rep.trip(SITE, reason=f"batched eval failed: {e!r}")
            if vals is None:
                fn = eval_fn if eval_fn is not None else \
                    (lambda a: float(eval_batched([a])[0]))
                vals = [float(fn(assemble(key))) for key in new_keys]
            for key, v in zip(new_keys, vals):
                memo[key] = float(v)
            n_evals += len(new_keys)

        def result_for(key, score, cand_coeffs):
            rt = runtime(key)
            return SearchResult(assignment=assemble(key), runtime=rt,
                                speedup=dense / rt, score=score,
                                coeffs=np.asarray(cand_coeffs).copy())

        # own-candidate acceptance drives the mutation trajectory: coeffs
        # only ever follow a target's own stream
        for k, C, ch in entries:
            for p in range(ch.shape[0]):
                if ch[p, 0] < 0:
                    continue
                key = tuple(int(c) for c in ch[p])
                score = memo[key]
                hist[k].append(score)
                if best[k] is None or score < best[k].score:
                    best[k] = result_for(key, score, C[p])
                    coeffs[k] = np.asarray(C[p]).copy()
                    if verbose:
                        print(f"  spdy[{targets[k]}x] round {rnd}: "
                              f"score={score:.5f} "
                              f"speedup={best[k].speedup:.2f}x")

        # cross-target harvest: a scored assignment whose true table
        # runtime meets another target's budget is a free candidate for
        # that target; kept apart from ``best`` so it never redirects the
        # target's own stream
        if share_pool and K > 1:
            for key in new_keys:
                score = memo[key]
                rt = runtime(key)
                for k in range(K):
                    cur = min((r.score for r in (best[k], harvested[k])
                               if r is not None), default=None)
                    if cur is not None and score >= cur:
                        continue
                    # exact budget check: the hard speedup guarantee
                    if rt <= dense / targets[k]:
                        harvested[k] = result_for(key, score,
                                                  producer[key])
                        if verbose:
                            print(f"  spdy[{targets[k]}x] round {rnd}: "
                                  f"harvested score={score:.5f}")
        producer.clear()
        rnd += 1

    out: Dict[float, SearchResult] = {}
    for k, t in enumerate(targets):
        res = best[k]
        if harvested[k] is not None and (res is None
                                         or harvested[k].score < res.score):
            res = harvested[k]
        if res is None:
            raise RuntimeError(
                f"SPDY found no feasible assignment for target {t}x")
        res.history = hist[k]
        res.n_evals = n_evals
        out[t] = res
    return out


def search(db: Dict[str, ModuleDB], table: LatencyTable,
           target_speedup: float, *, steps: int = 1000, pop: int = 16,
           mutate_frac: float = 0.1, nbins: int = 1024,
           eval_fn: Optional[Callable[[Dict[str, int]], float]] = None,
           eval_batched: Optional[
               Callable[[List[Dict[str, int]]], np.ndarray]] = None,
           seed: SeedLike = 0, batched: bool = True,
           devices: Optional[List] = None, mesh=None,
           verbose: bool = False) -> SearchResult:
    """Single-target random-mutation search (paper §3.2): a one-target
    `search_family`, with the JAX package's signature and ``mesh``.
    ``batched=False`` is the serial equivalence reference (the same
    rounds and mutations, the scalar DP, per-candidate ``eval_fn``)."""
    return search_family(
        db, table, [target_speedup], steps=steps, pop=pop,
        mutate_frac=mutate_frac, nbins=nbins, eval_fn=eval_fn,
        eval_batched=eval_batched, seed=seed, batched=batched,
        devices=devices, mesh=mesh, verbose=verbose)[target_speedup]
