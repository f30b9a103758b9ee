"""The port's placed SPDY populations (``core/spdy.py``
``search_family(devices=)`` and ``search(devices=)``, ROADMAP Queue 1
item 6b) against its unplaced search and the JAX package's placed
search, on the CPU.

Each round's new candidates fall into one partition per first-producing
target; partition ``k`` is scored by one scorer call on
``devices[k % len(devices)]``, one thread a partition. A candidate's
score does not depend on the others in its call, so the placed search
gives every target the unplaced search's assignment, score, history and
``n_evals`` bit for bit: the bound of the reference's
``tests/test_sharded_db.py::test_placed_search_family_bit_identical_2dev``
(tier 2), whose settings (the reference tests' ``gpt2-tiny`` in fp32,
its synthetic Hessians, targets 1.5x and 2x, 24 steps in populations of
8, seed 3) these tests take, at 6 layers instead of 2: at 2 layers (4
modules) the search finds 4 unique candidates, all of the first
target's, so a placed round would have one partition. The mesh form
(one process a rank) is tested in ``tests/test_torch_sharded.py``, the
card's streams in ``tests/test_torch_cuda.py``.

Against the JAX package: one numpy scorer (``SCORER_SRC``, shared as
source text) drives the port's placed search, the reference's placed
search on 2 forced CPU devices (one launch of the reference's own
``run_forced_devices``) and the reference's unplaced search in this
process, on the same database and table: the same results bit for bit.
"""
import dataclasses
import pickle
import types

import numpy as np
import pytest
import torch

from repro.core import database as ref_database
from repro.core import latency as ref_latency
from repro.core import spdy as ref_spdy
from repro.core.structures import PrunableModule as RefPrunableModule
from repro.launch.subproc import run_forced_devices
from repro.runtime import costmodel as ref_costmodel
from repro_torch.configs import GPT2_SMALL
from repro_torch.core import spdy
from repro_torch.core.database import SnapshotCache, build_database
from repro_torch.core.latency import build_table
from repro_torch.core.oneshot import make_batched_eval
from repro_torch.core.structures import registry
from repro_torch.data import calibration_batches
from repro_torch.models import model_init
from repro_torch.robustness import FaultPlan, install, report_scope
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

# the reference tests' TINY
TINY_KW = dict(name="gpt2-tiny", num_layers=2, d_model=64, d_ff=128,
               num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256,
               dtype="float32")
CFG = GPT2_SMALL.replace(**TINY_KW).replace(num_layers=6)
TARGETS = [1.5, 2.0]
TARGETS3 = [1.25, 1.5, 2.0]
TWINS = [1.5, 1.5 + 1e-9]
SEARCH_KW = dict(steps=24, pop=8, seed=3)
SITE = "spdy.batched_eval"
CPU = torch.device("cpu")
FORCED_TIMEOUT = 300

# a loss-free population scorer, run by both packages: a float64 a
# candidate that any module's level moves, and each call's device
SCORER_SRC = r'''
import numpy as np


def make_scorer(calls):
    def eval_batched(assignments, device=None):
        calls.append(str(device))
        return np.asarray(
            [sum(np.sin(0.37 * (i + 1) * (lvl + 1.0))
                 for i, (_, lvl) in enumerate(sorted(a.items())))
             for a in assignments], np.float64)

    eval_batched.supports_device = True
    return eval_batched
'''
_ns = {}
exec(SCORER_SRC, _ns)
make_scorer = _ns["make_scorer"]

# the reference's placed search on its forced devices (PATH, TARGETS,
# SEARCH_KW and SCORER_SRC come first)
REFERENCE_RUN = r'''
import json
import pickle

import jax

from repro.core.spdy import search_family

with open(PATH, "rb") as f:
    db, table = pickle.load(f)
calls = []
res = search_family(db, table, TARGETS, eval_batched=make_scorer(calls),
                    devices=jax.devices(), **SEARCH_KW)
print("RESULT" + json.dumps({
    "ndev": jax.device_count(), "devices": sorted(set(calls)),
    "results": {str(t): {"assignment": r.assignment, "score": r.score,
                         "runtime": r.runtime, "history": r.history,
                         "n_evals": r.n_evals} for t, r in res.items()}}))
'''


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """Seeded weights, the database of the reference test's synthetic
    Hessians, its snapshot cache, one calibration batch of 8 x 64 and
    the cost-model table."""
    params = model_init(CFG, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    h = {}
    for m in registry(CFG):
        X = rng.standard_normal((3 * m.d_in + 16, m.d_in))
        h[m.name] = torch.from_numpy(X.T @ X / len(X)).float()
    db = build_database(CFG, params, h, device="cpu")
    return types.SimpleNamespace(
        params=params, db=db, cache=SnapshotCache(CFG, db, device="cpu"),
        calib=calibration_batches(CFG, 16, 64, batch=8)[:1],
        table=build_table(CFG, InferenceEnv(batch=1, seq=64, hw=H100_SXM),
                          device="cpu"))


def scorer(s):
    return make_batched_eval(CFG, s.params, s.cache, s.calib, device="cpu")


def family(s, targets=TARGETS, eval_batched=None, **kw):
    return spdy.search_family(
        s.db, s.table, targets,
        eval_batched=scorer(s) if eval_batched is None else eval_batched,
        **SEARCH_KW, **kw)


@pytest.fixture(scope="module")
def unplaced(tiny):
    return {tuple(t): family(tiny, t) for t in (TARGETS, TARGETS3)}


def assert_same(got, want):
    assert list(got) == list(want)
    for t in want:
        assert got[t].assignment == want[t].assignment, t
        assert got[t].score == want[t].score, t
        assert got[t].runtime == want[t].runtime, t
        assert got[t].speedup == want[t].speedup, t
        assert got[t].history == want[t].history, t
        assert got[t].n_evals == want[t].n_evals, t


def test_the_unplaced_families_meet_their_targets(unplaced):
    for targets, res in unplaced.items():
        assert all(res[t].speedup >= t for t in targets)
        assert all(len(r.history) == SEARCH_KW["steps"]
                   for r in res.values())
        assert res[targets[0]].n_evals > 2 * len(targets)


# ---------------------------------------------------------------------------
# placed equals unplaced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev,targets", [(2, TARGETS), (3, TARGETS),
                                          (2, TARGETS3)],
                         ids=["2-devices", "3-devices",
                              "3-targets-on-2-devices"])
def test_placed_search_equals_unplaced_loss_scored(tiny, unplaced, ndev,
                                                   targets):
    spdy.reset_placed_scoring()
    got = family(tiny, targets, devices=[CPU] * ndev)
    assert_same(got, unplaced[tuple(targets)])
    # every round was placed, each target's partition a call of its own:
    # the partitions scored every candidate
    placed = spdy.PLACED_SCORING
    assert sum(placed["scored"].values()) == got[targets[0]].n_evals
    assert sorted(placed["scored"]) == list(range(len(targets)))
    assert placed["calls"] > SEARCH_KW["steps"] // SEARCH_KW["pop"]
    assert placed["all_gathers"] == 0


def test_search_with_devices_is_the_placed_family(tiny, unplaced):
    t = TARGETS[0]
    kw = dict(eval_batched=scorer(tiny), **SEARCH_KW)
    got = spdy.search(tiny.db, tiny.table, t, devices=[CPU, CPU], **kw)
    want = spdy.search_family(tiny.db, tiny.table, [t],
                              devices=[CPU, CPU], **kw)
    assert_same({t: got}, want)
    assert_same({t: got}, {t: spdy.search(tiny.db, tiny.table, t, **kw)})


def test_devices_and_mesh_together_raise(tiny):
    with pytest.raises(ValueError, match="not both"):
        family(tiny, devices=[CPU, CPU], mesh=object())


# ---------------------------------------------------------------------------
# the bookkeeping of a placed round
# ---------------------------------------------------------------------------

def _expected_calls(db, dp_log, K, devices):
    """Each round's expected scorer calls, from the DP's own choices: the
    new keys of the round, each in the partition of the first target
    that produced it, as ``(device, assignments)`` sorted."""
    names = list(db)
    seen, rounds = set(), []
    for r in range(0, len(dp_log), K):
        parts = {}
        for k, ch in enumerate(dp_log[r:r + K]):
            for row in ch:
                key = tuple(int(c) for c in row)
                if row[0] < 0 or key in seen:
                    continue
                seen.add(key)
                parts.setdefault(k, []).append(tuple(
                    (n, int(db[n].levels[c])) for n, c in zip(names, key)))
        rounds.append(sorted((str(devices[k % len(devices)]), a)
                             for k, a in parts.items()))
    return rounds


@pytest.mark.parametrize("targets", [TARGETS, TARGETS3, TWINS],
                         ids=["2-targets", "3-targets", "twin-targets"])
def test_one_call_per_producing_target_on_its_device(tiny, monkeypatch,
                                                     targets):
    """Checked against the DP's own choices. The twin targets' budgets
    quantize alike, so both produce round 0's unmutated candidate: it is
    the first target's."""
    devices = [torch.device("cpu", i) for i in range(2)]
    log = []  # ("dp", choices) and ("call", device, assignments), in order
    dp = spdy.dp_select_batched

    def recording_dp(*a, **kw):
        ch, tot = dp(*a, **kw)
        log.append(("dp", ch.copy()))
        return ch, tot

    def recording(assignments, device=None):
        log.append(("call", str(device), list(assignments)))
        return make_scorer([])(assignments)

    recording.supports_device = True
    monkeypatch.setattr(spdy, "dp_select_batched", recording_dp)
    family(tiny, targets, eval_batched=recording, devices=devices)
    rounds, cur = [], None
    for e in log:
        if e[0] == "dp":
            if cur is None or cur["calls"]:
                cur = {"dp": [], "calls": []}
                rounds.append(cur)
            cur["dp"].append(e[1])
        else:
            cur["calls"].append((e[1], [tuple(a.items()) for a in e[2]]))
    want = _expected_calls(tiny.db, [c for r in rounds for c in r["dp"]],
                           len(targets), devices)
    got = [sorted(r["calls"]) for r in rounds]
    assert len(got) == SEARCH_KW["steps"] // SEARCH_KW["pop"]
    assert got == want
    if targets is TWINS:  # a key of both twins' round 0 is the first's
        twin = [np.array_equal(a[0], b[0]) for a, b in
                zip(rounds[0]["dp"][:1], rounds[0]["dp"][1:])]
        assert twin == [True]


@pytest.mark.parametrize("case", ["no-supports-device", "one-device"])
def test_unplaced_cases(tiny, unplaced, case):
    """A scorer without ``supports_device``, or a one-entry list, runs
    unplaced: one call a round, no ``device`` keyword."""
    inner, calls = scorer(tiny), []

    if case == "no-supports-device":
        def fn(assignments):
            calls.append(None)
            return inner(assignments)
        devices = [CPU, CPU]
    else:
        def fn(assignments, **kw):
            calls.append(kw.get("device"))
            return inner(assignments)
        fn.supports_device = True
        devices = [CPU]
    spdy.reset_placed_scoring()
    assert_same(family(tiny, eval_batched=fn, devices=devices),
                unplaced[tuple(TARGETS)])
    assert calls == [None] * len(calls)
    assert 0 < len(calls) <= SEARCH_KW["steps"] // SEARCH_KW["pop"]
    assert spdy.PLACED_SCORING["calls"] == 0


class PeerMesh:
    """A stand-in for rank 1 of a 2-rank ``distributed.Mesh``: rank 0's
    failure flag and score row are given, and every collective call is
    recorded."""
    size = 2

    def __init__(self, peer_row, peer_failed=False):
        self.peer_row, self.peer_failed, self.calls = peer_row, peer_failed, []

    def index(self):
        return 1

    def any(self, flag):
        self.calls.append("any")
        return bool(flag) or self.peer_failed

    def all_gather(self, a):
        self.calls.append("all_gather")
        return np.concatenate([self.peer_row[None, :], a])


@pytest.mark.parametrize("peer_failed", [False, True],
                         ids=["gathered", "peer-failed"])
def test_a_rank_that_owns_no_partition_keeps_in_step(peer_failed):
    """Targets 0 and 2 produced the round's keys, so rank 1 of 2 owns no
    partition: it still calls the round's one ``any`` and, unless a rank
    failed, its one all-gather, and reads every score from rank 0's
    row."""
    keys = [(0,), (1,), (2,)]
    peer = np.array([0.25, 0.5, 0.75])
    mesh, scored = PeerMesh(peer, peer_failed), []

    def fn(assignments):
        scored.append(assignments)
        return np.zeros(len(assignments))

    with report_scope() as rep:
        got = spdy._eval_on_ranks(fn, lambda k: {"m": k[0]}, keys,
                                  [0, 0, 2], mesh, rep)
    assert scored == []
    if peer_failed:
        assert got is None and mesh.calls == ["any"]
        assert rep.as_dict()["counts"]["demotions"] == {SITE: 1}
    else:
        np.testing.assert_array_equal(got, peer)
        assert mesh.calls == ["any", "all_gather"]
        assert not rep.breaker_open(SITE)


# ---------------------------------------------------------------------------
# the scorer's replicas
# ---------------------------------------------------------------------------

def _some_assignments(s, unplaced):
    res = unplaced[tuple(TARGETS3)]
    return [{n: 0 for n in s.db}] + [r.assignment for r in res.values()]


def test_scorer_on_a_device_equals_its_own_replica(tiny, unplaced):
    fn = scorer(tiny)
    a = _some_assignments(tiny, unplaced)
    own = fn(a)
    assert fn.replicas == {}
    for device in ("cpu", CPU, torch.device("cpu", 0)):
        np.testing.assert_array_equal(fn(a, device=device), own)
    # three names of one device share one replica
    assert list(fn.replicas) == [CPU]
    assert fn.supports_device


def test_a_score_does_not_depend_on_its_call_company(tiny, unplaced):
    fn = scorer(tiny)
    a = _some_assignments(tiny, unplaced)
    whole = fn(a)
    np.testing.assert_array_equal(
        np.concatenate([fn(a[i:i + 1]) for i in range(len(a))]), whole)
    np.testing.assert_array_equal(fn(a[::-1]), whole[::-1])


# ---------------------------------------------------------------------------
# the degradation rung in a placed round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["raise@0", "raise@1"])
def test_injected_fault_in_a_partition_demotes_once(tiny, unplaced, rule):
    """``raise@N`` fires at the N-th partition call: both fire in round 0
    (two partitions), so no placed round completes, and the search ends
    serially with the unplaced results."""
    spdy.reset_placed_scoring()
    with install(FaultPlan.parse(f"{SITE}:{rule}")), report_scope() as rep:
        got = family(tiny, devices=[CPU, CPU])
    assert_same(got, unplaced[tuple(TARGETS)])
    counts = rep.as_dict()["counts"]
    assert counts["injected"] == {SITE: 1}
    assert counts["demotions"] == {SITE: 1}
    assert rep.breaker_open(SITE)
    assert spdy.PLACED_SCORING["calls"] == 0


def test_the_site_counts_partition_calls(tiny):
    """One hit a partition call placed, one a round unplaced."""
    spdy.reset_placed_scoring()
    never = f"{SITE}:raise@100000"
    with install(FaultPlan.parse(never)) as plan, report_scope() as rep:
        family(tiny, devices=[CPU, CPU])
    assert plan.hits[SITE] == spdy.PLACED_SCORING["calls"]
    with install(FaultPlan.parse(never)) as flat, report_scope():
        family(tiny)
    assert flat.hits[SITE] <= SEARCH_KW["steps"] // SEARCH_KW["pop"]
    assert plan.hits[SITE] > flat.hits[SITE]
    assert rep.total("demotions") == 0


def test_out_of_memory_in_a_partition_demotes_once(tiny, unplaced):
    inner = scorer(tiny)
    failed = []

    def fn(assignments, device=None):
        if device is not None and not failed:
            failed.append(device)
            raise torch.cuda.OutOfMemoryError("out of memory (by hand)")
        return inner(assignments, device=device)

    fn.supports_device = True
    with report_scope() as rep:
        got = family(tiny, eval_batched=fn, devices=[CPU, CPU])
    assert_same(got, unplaced[tuple(TARGETS)])
    assert rep.as_dict()["counts"]["demotions"] == {SITE: 1}


@pytest.mark.parametrize("bad", [0, 1], ids=["first", "second"])
def test_an_error_that_is_not_demotable_wins_over_a_demotable_one(tiny,
                                                                  bad):
    """One partition runs out of memory, the other fails otherwise: the
    round raises the other failure, whichever partition it is."""
    def fn(assignments, device=None):
        if device.index == bad:
            raise ValueError("a partition fails on purpose")
        raise torch.cuda.OutOfMemoryError("out of memory (by hand)")

    fn.supports_device = True
    with report_scope() as rep, pytest.raises(ValueError, match="purpose"):
        family(tiny, eval_batched=fn,
               devices=[torch.device("cpu", 0), torch.device("cpu", 1)])
    assert not rep.breaker_open(SITE)


def test_any_other_error_in_a_partition_raises(tiny):
    inner = scorer(tiny)

    def fn(assignments, device=None):
        if str(device) == "cpu:1":
            raise ValueError("a partition fails on purpose")
        return inner(assignments, device=device)

    fn.supports_device = True
    with report_scope() as rep, pytest.raises(ValueError, match="purpose"):
        family(tiny, eval_batched=fn,
               devices=[torch.device("cpu", 0), torch.device("cpu", 1)])
    assert not rep.breaker_open(SITE)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _ref_db(db):
    """The port's database as the reference's ModuleDBs (same arrays)."""
    return {name: ref_database.ModuleDB(
        mod=RefPrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for name, m in db.items()}


def _ref_table(tab):
    hw = ref_costmodel.HardwareSpec(**dataclasses.asdict(tab.env.hw))
    return ref_latency.LatencyTable(
        env=ref_costmodel.InferenceEnv(batch=tab.env.batch, seq=tab.env.seq,
                                       hw=hw),
        grids=dict(tab.grids), times=dict(tab.times), base=tab.base)


@pytest.fixture(scope="module")
def reference(tiny, tmp_path_factory):
    """The reference's placed search (2 forced devices, a subprocess)
    and its unplaced search (here), with the numpy scorer, on the port's
    database and table."""
    db, table = _ref_db(tiny.db), _ref_table(tiny.table)
    path = tmp_path_factory.mktemp("placed") / "db_table.pkl"
    with open(path, "wb") as f:
        pickle.dump((db, table), f)
    script = (f"PATH = {str(path)!r}\nTARGETS = {TARGETS!r}\n"
              f"SEARCH_KW = {SEARCH_KW!r}\n" + SCORER_SRC + REFERENCE_RUN)
    placed = run_forced_devices(script, 2, timeout=FORCED_TIMEOUT)
    unplaced = ref_spdy.search_family(db, table, TARGETS,
                                      eval_batched=make_scorer([]),
                                      **SEARCH_KW)
    return placed, unplaced


def _as_record(r):
    return {"assignment": r.assignment, "score": r.score,
            "runtime": r.runtime, "history": r.history,
            "n_evals": r.n_evals}


def test_reference_search_was_placed_on_two_devices(reference):
    placed, _ = reference
    assert placed["ndev"] == 2
    assert len(placed["devices"]) == 2


def test_port_placed_search_equals_the_reference_placed_search(tiny,
                                                               reference):
    placed, _ = reference
    calls = []
    got = family(tiny, eval_batched=make_scorer(calls), devices=[CPU, CPU])
    assert set(calls) == {"cpu"}
    assert {str(t): _as_record(r) for t, r in got.items()} == \
        placed["results"]


def test_port_placed_search_equals_the_reference_unplaced_search(
        tiny, reference):
    _, unplaced = reference
    got = family(tiny, eval_batched=make_scorer([]), devices=[CPU, CPU])
    for t in TARGETS:
        assert _as_record(got[t]) == _as_record(unplaced[t]), t
