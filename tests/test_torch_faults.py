"""The port's robustness layer (``repro_torch.robustness`` and its fault
sites) on the CPU, held against the JAX package's ``repro.robustness``
under the same plans: the spec grammar and hit counters, the poison and
byte-flip helpers, bounded I/O retry, breakers and report scopes; then
one scenario per fault site, each run under one plan in both packages
where the reference has the same path, and a fault-free run under an
armed plan bit for bit equal to a run with none.

Where the port deviates by design, the test pins the deviation: an
injected ``kernel.pallas`` failure raises out of the wrapper (the
reference demotes to its jnp oracle), and only a fault injected at the
rung's own site or a CUDA out-of-memory error demotes
``latency.measure`` and ``spdy.batched_eval`` (any other error raises,
a ``kernel.pallas`` fault inside the rung included, where the reference
demotes on every exception).

Tolerances: Hessians 1e-5 of the largest entry and float16 snapshots
2e-3 against the reference, as in tests/test_torch_core.py (the same
weights and tokens, fp32 sums taken in other orders); everything within
the port bit for bit.
"""
import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.robustness as R
from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import latency as ref_latency
from repro.core.database import build_database as ref_build_database
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.latency_cache import LatencyCache as RefLatencyCache
from repro.core.pipeline import _save_artifact as ref_save_artifact
from repro.core.spdy import search as ref_search
from repro.data import calibration_batches as ref_calibration_batches
from repro.kernels import ops as ref_ops
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import synthetic_requests as ref_synthetic_requests
from repro.train.trainer import Trainer as RefTrainer

import repro_torch.robustness as P
from repro_torch import kernels
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointWriteError)
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core import latency
from repro_torch.core.database import (ModuleDB, SnapshotCache,
                                       build_database)
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.latency import build_costmodel_table, build_table
from repro_torch.core.latency_cache import LatencyCache
from repro_torch.core.oneshot import (calib_loss_fn, make_batched_eval,
                                      oneshot_prune)
from repro_torch.core.pipeline import (FamilyPreempted, _save_artifact,
                                       family_run_dir, gradual_prune)
from repro_torch.core.shrink import shrink
from repro_torch.core.spdy import search
from repro_torch.core.structures import PrunableModule
from repro_torch.data import calibration_batches, synthetic_stream
from repro_torch.models import model_init
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves
from repro_torch.robustness import faults
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.serve import (DenseServeModel, PrunedServeModel,
                               ServeEngine, synthetic_requests)
from repro_torch.train import Trainer

JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=8, seq=64, mode="prefill")
ENV = InferenceEnv(hw=HW, **ENV_KW)
FT_STEPS = 8
TARGETS = [1.5, 2.0]
MAX_LEN = 64
# every port site armed, none reaching its nth hit
ARMED = ",".join(f"{s}:raise@1000000" for s in P.SITES)


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
def cfg(tiny_cfg):
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(tiny_cfg)
                          .items() if k not in JAX_EXECUTION})


@pytest.fixture(scope="module")
def params(tiny_params):
    return params_from_numpy(jax.tree.map(np.asarray, tiny_params),
                             device="cpu")


@pytest.fixture(scope="module")
def ref(tiny_cfg, tiny_params):
    """The reference's three calibration batches and clean Hessians."""
    calib = ref_calibration_batches(tiny_cfg, 24, 64, batch=8)
    return {"calib": calib,
            "hess": ref_collect_hessians(tiny_cfg, tiny_params, calib)}


@pytest.fixture(scope="module")
def calib(cfg):
    return calibration_batches(cfg, 24, 64, batch=8)


def _hess(ref):
    return {k: torch.from_numpy(np.array(v)) for k, v in ref["hess"].items()}


@pytest.fixture(scope="module")
def db(cfg, params, ref):
    return build_database(cfg, params, _hess(ref), device="cpu")


def _counts(rep):
    """A report's counts with the empty buckets dropped."""
    return {b: d for b, d in rep.as_dict()["counts"].items() if d}


# ----------------------------------------------------------------------
# plan, report and primitives, against repro.robustness
# ----------------------------------------------------------------------

SPECS = ["calib.batch:nan@2x3, ckpt.async_write:oserror~0.2,"
         "latency.measure:delay@1~0.01",
         "obs.cholesky:inf,serve.step:nan@2,serve.step:raise@4",
         "db.artifact_write:corrupt@0,ckpt.async_write:oserror@0x2"]
RULE_FIELDS = ("site", "mode", "nth", "count", "delay_s")


def _fired(pkg, spec, sequence):
    """The (site, mode) each hit of ``sequence`` fires under ``spec``
    (the raising modes as their exception's name), and the plan's log."""
    plan = pkg.FaultPlan.parse(spec, seed=7)
    out = []
    with pkg.install(plan), pkg.report_scope():
        for site in sequence:
            try:
                rule = pkg.hit(site)
                out.append(None if rule is None else rule.mode)
            except (pkg.FaultInjected, pkg.FaultIOError) as e:
                out.append(type(e).__name__)
    return out, plan.fired


@pytest.mark.parametrize("spec", SPECS)
def test_spec_gives_the_references_rules_and_fired_sequence(spec):
    want = R.FaultPlan.parse(spec, seed=7)
    got = P.FaultPlan.parse(spec, seed=7)
    assert got.seed == want.seed
    assert [tuple(getattr(r, f) for f in RULE_FIELDS) for r in got.rules] \
        == [tuple(getattr(r, f) for f in RULE_FIELDS) for r in want.rules]
    sequence = [r.site for r in want.rules for _ in range(6)]
    assert _fired(P, spec, sequence) == _fired(R, spec, sequence)


def test_plan_from_the_environment_as_the_reference_reads_it(monkeypatch):
    env = {"ZIPLM_FAULTS": "obs.cholesky:nan@1", "ZIPLM_FAULT_SEED": "3"}
    for pkg in (P, R):
        plan = pkg.FaultPlan.from_env(env)
        assert plan.seed == 3 and plan.rules[0].site == "obs.cholesky"
        assert plan.rules[0].nth == 1
        assert pkg.FaultPlan.from_env({}) is None
    # the ambient plan: read once from $ZIPLM_FAULTS, counters kept
    monkeypatch.setenv("ZIPLM_FAULTS", "calib.batch:nan@1")
    monkeypatch.setattr(faults, "_ACTIVE", [None])
    monkeypatch.setattr(faults, "_ENV_CHECKED", [False])
    plan = P.active_plan()
    assert plan is not None and plan.rules[0].site == "calib.batch"
    with P.report_scope():
        assert P.poison_scalar("calib.batch") == 1.0
        assert np.isnan(P.poison_scalar("calib.batch"))
    assert P.active_plan() is plan and plan.hits == {"calib.batch": 2}


def test_unknown_and_unported_sites_and_modes_are_refused():
    for pkg in (P, R):
        with pytest.raises(ValueError, match="site"):
            pkg.FaultPlan.parse("no.such.site:raise")
        with pytest.raises(ValueError, match="mode"):
            pkg.FaultPlan.parse("calib.batch:explode")
        with pytest.raises(ValueError, match="grammar"):
            pkg.FaultPlan.parse("calib.batch")
        with pytest.raises(ValueError, match="site"):
            pkg.hit("not.a.site")  # even with no plan installed
    # every site of the reference is a port site, db.sharded_group too
    assert set(P.SITES) == set(R.faults.SITES)
    for pkg in (P, R):
        rule, = pkg.FaultPlan.parse("db.sharded_group:raise@0").rules
        assert (rule.site, rule.mode, rule.nth) == ("db.sharded_group",
                                                     "raise", 0)
    assert P.hit("db.sharded_group") is None  # no plan installed


def test_nth_count_and_oserror_as_the_reference():
    for pkg in (P, R):
        with pkg.install(pkg.FaultPlan.parse("calib.batch:raise@1x2")), \
                pkg.report_scope():
            fired = []
            for _ in range(5):
                try:
                    pkg.hit("calib.batch")
                    fired.append(False)
                except pkg.FaultInjected:
                    fired.append(True)
            assert fired == [False, True, True, False, False]
            assert pkg.hit("obs.cholesky") is None  # its own counter
        assert pkg.hit("calib.batch") is None       # plan uninstalled
        with pkg.install(pkg.FaultPlan.parse("ckpt.async_write:oserror")), \
                pkg.report_scope():
            with pytest.raises(OSError):
                pkg.hit("ckpt.async_write")


def test_poison_is_the_identity_when_clean():
    x = torch.arange(4.0)
    assert P.poison_scalar("calib.batch") == 1.0
    assert P.poison_array("obs.cholesky", x) is x
    with P.install(P.FaultPlan.parse("obs.cholesky:raise@5")):
        assert P.poison_array("obs.cholesky", x) is x   # armed, not fired
    xr = jnp.arange(4.0)
    for pkg, arr in ((P, x), (R, xr)):
        with pkg.install(pkg.FaultPlan.parse(
                "calib.batch:nan,obs.cholesky:inf")), pkg.report_scope():
            assert np.isnan(pkg.poison_scalar("calib.batch"))
            out = pkg.poison_array("obs.cholesky", arr)
        assert np.isinf(np.asarray(out)[1:]).all()
    assert out is not xr


def test_corrupt_bytes_flips_the_references_bytes(tmp_path):
    payload = bytes(range(256)) * 9
    files = {}
    for name in ("port5", "ref5", "port6", "planned", "ref_planned"):
        files[name] = str(tmp_path / name)
        with open(files[name], "wb") as f:
            f.write(payload)
    assert P.corrupt_bytes(files["port5"], seed=5)
    assert R.corrupt_bytes(files["ref5"], seed=5)
    P.corrupt_bytes(files["port6"], seed=6)
    for pkg, name in ((P, "planned"), (R, "ref_planned")):
        with pkg.install(pkg.FaultPlan.parse("db.artifact_write:corrupt",
                                             seed=5)), pkg.report_scope():
            assert pkg.faults.corrupt_file("db.artifact_write", files[name])
    got = {k: open(p, "rb").read() for k, p in files.items()}
    assert got["port5"] == got["ref5"] == got["planned"] \
        == got["ref_planned"] != payload
    assert got["port6"] != got["port5"]


def _flaky():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 2:
            raise OSError(11, "try again")
        return "ok"
    return fn


def _dead():
    raise OSError(5, "dead")


def test_retry_io_counts_as_the_reference():
    got = {}
    for pkg in (P, R):
        with pkg.report_scope() as healed:
            out, rule = pkg.retry_io(_flaky(), site="db.artifact_write")
        assert out == "ok" and rule is None
        with pkg.report_scope() as dead:
            with pytest.raises(OSError):
                pkg.retry_io(_dead, site="db.artifact_write", attempts=2,
                             backoff_s=0.0)
        with pkg.install(pkg.FaultPlan.parse(
                "ckpt.async_write:oserror@0x2")), \
                pkg.report_scope() as injected:
            out, _ = pkg.retry_io(lambda: "ok", site="ckpt.async_write",
                                  backoff_s=0.0)
        got[pkg] = [_counts(r) for r in (healed, dead, injected)]
    assert got[P] == got[R]
    assert got[P][0] == {"retries": {"db.artifact_write": 1},
                         "recovered": {"db.artifact_write": 1}}


def test_breaker_trips_and_logs_once_as_the_reference(capsys):
    dicts = []
    for pkg in (P, R):
        rep = pkg.RobustnessReport()
        assert not rep.breaker_open("latency.measure")
        rep.trip("latency.measure", reason="boom")
        rep.trip("latency.measure", reason="boom again")
        assert rep.breaker_open("latency.measure")
        assert capsys.readouterr().out.count("demoted latency.measure") == 1
        dicts.append(rep.as_dict())
    assert dicts[0] == dicts[1]
    assert dicts[0]["counts"]["demotions"] == {"latency.measure": 1}


def test_report_scopes_nest():
    outer = P.current_report()
    with P.report_scope() as rep:
        assert P.current_report() is rep and rep is not outer
        with P.report_scope(rep):
            assert P.current_report() is rep
        with P.report_scope() as inner:
            assert P.current_report() is inner
        assert P.current_report() is rep
    assert P.current_report() is outer


def test_all_finite_on_tensors_as_the_reference_on_arrays():
    cases = [[np.ones(3)], [np.ones(3), np.array([1.0, np.nan])],
             [np.array([np.inf])], []]
    for arrays in cases:
        want = R.all_finite(*arrays)
        assert P.all_finite(*[torch.from_numpy(a) for a in arrays]) == want
        assert P.all_finite(*arrays) == want


# ----------------------------------------------------------------------
# calib.batch
# ----------------------------------------------------------------------

def test_calib_batch_nan_is_skipped_as_the_reference_skips_it(
        cfg, params, calib, ref, tiny_cfg, tiny_params):
    """``calib.batch:nan@1``: the port's Hessians equal a clean port run
    over batches 0 and 2 bit for bit, and the reference's under the same
    plan within 1e-5 of the largest entry; equal counts."""
    plan = "calib.batch:nan@1"
    with P.install(P.FaultPlan.parse(plan)), P.report_scope() as rep:
        got = collect_hessians(cfg, params, calib, device="cpu")
    clean = collect_hessians(cfg, params, [calib[0], calib[2]],
                             device="cpu")
    with R.install(R.FaultPlan.parse(plan)), R.report_scope() as ref_rep:
        want = ref_collect_hessians(tiny_cfg, tiny_params, ref["calib"])
    assert _counts(rep) == _counts(ref_rep) == {
        "injected": {"calib.batch": 1}, "detected": {"calib.batch": 1},
        "recovered": {"calib.batch": 1}}
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(),
                                      clean[name].numpy())
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_every_calib_batch_poisoned_raises(cfg, params, calib, ref,
                                           tiny_cfg, tiny_params):
    plan = f"calib.batch:nan@0x{len(calib)}"
    with P.install(P.FaultPlan.parse(plan)), P.report_scope():
        with pytest.raises(FloatingPointError, match="every calibration"):
            collect_hessians(cfg, params, calib, device="cpu")
    with R.install(R.FaultPlan.parse(plan)), R.report_scope():
        with pytest.raises(FloatingPointError, match="every calibration"):
            ref_collect_hessians(tiny_cfg, tiny_params, ref["calib"])


# ----------------------------------------------------------------------
# obs.cholesky
# ----------------------------------------------------------------------

def test_obs_cholesky_nan_heals_on_the_ladder_as_the_reference(
        cfg, params, db, ref, tiny_cfg, tiny_params):
    """``obs.cholesky:nan@0`` poisons the first chunk's (the attention
    modules') inverse Hessian: it heals at rung 1 and equals a clean
    build at damp x 10, the FFN chunk a clean build at the damp; the
    reference under the same plan gives the same orders and counts."""
    plan = "obs.cholesky:nan@0"
    with P.install(P.FaultPlan.parse(plan)), P.report_scope() as rep:
        got = build_database(cfg, params, _hess(ref), device="cpu")
    with R.install(R.FaultPlan.parse(plan)), R.report_scope() as ref_rep:
        want = ref_build_database(tiny_cfg, tiny_params, ref["hess"])
    assert _counts(rep) == _counts(ref_rep) == {
        "injected": {"obs.cholesky": 1}, "detected": {"obs.cholesky": 1},
        "recovered": {"obs.cholesky": 1}, "retries": {"obs.cholesky": 1}}
    rung1 = build_database(cfg, params, _hess(ref),
                           damp=P.damp_schedule(1e-4)[1], device="cpu")
    for name, w in want.items():
        g = got[name]
        np.testing.assert_array_equal(g.order, w.order, err_msg=name)
        np.testing.assert_allclose(g.snapshots.astype(np.float32),
                                   w.snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=name)
        clean = rung1[name] if g.mod.kind == "attn" else db[name]
        for f in ("order", "errors", "snapshots"):
            np.testing.assert_array_equal(getattr(g, f), getattr(clean, f),
                                          err_msg=f"{name} {f}")
    assert any(db[n].errors[1] != rung1[n].errors[1] for n in db
               if db[n].mod.kind == "attn")  # the rungs differ


# ----------------------------------------------------------------------
# db.artifact_write and ckpt.async_write
# ----------------------------------------------------------------------

def test_artifact_write_corrupt_after_write_is_caught_on_load(tmp_path):
    """The ``corrupt`` mode flips bytes after the write in both packages:
    the returned sha256 no longer matches the file, and the checked load
    quarantines it; equal counts."""
    arrays = {"a": np.arange(600, dtype=np.float32)}
    reps = []
    for pkg, save, name in ((P, _save_artifact, "port.npz"),
                            (R, ref_save_artifact, "ref.npz")):
        path = str(tmp_path / name)
        with pkg.install(pkg.FaultPlan.parse("db.artifact_write:corrupt@0")), \
                pkg.report_scope() as rep:
            sha = save(path, arrays)
            assert pkg.file_sha256(path) != sha
            assert pkg.checked_npz_load(path, sha,
                                        site="db.artifact_write") is None
        assert os.path.exists(path + ".corrupt")
        reps.append(_counts(rep))
    assert reps[0] == reps[1] == {"injected": {"db.artifact_write": 1},
                                  "detected": {"db.artifact_write": 1}}


@pytest.mark.parametrize("spec", ["ckpt.async_write:oserror@0x2",
                                  "ckpt.async_write:oserror@0x3"])
def test_async_checkpoint_write_faults_as_the_reference(spec, tmp_path):
    """Two failed attempts heal on the third; three surface as
    CheckpointWriteError from ``wait()``, in both packages, with equal
    counts."""
    got = []
    for pkg, mgr_cls, leaf, name in (
            (P, CheckpointManager, torch.ones(2), "port"),
            (R, RefCheckpointManager, jnp.ones((2,)), "ref")):
        with pkg.install(pkg.FaultPlan.parse(spec)), \
                pkg.report_scope() as rep:
            m = mgr_cls(str(tmp_path / name), keep=2)
            m.save(1, {"a": leaf})
            if spec.endswith("x3"):
                with pytest.raises(Exception) as ei:
                    m.wait()
                assert type(ei.value).__name__ == "CheckpointWriteError"
                assert pkg is R or isinstance(ei.value, CheckpointWriteError)
                assert any(isinstance(e, OSError) for e in ei.value.errors)
                assert m.latest_step() is None
            else:
                m.wait()
                assert m.latest_step() == 1
            m.close()
        got.append(_counts(rep))
    assert got[0] == got[1]


# ----------------------------------------------------------------------
# latency.measure
# ----------------------------------------------------------------------

MEASURE_KW = dict(grid_subsample=8, reps=1)


def test_latency_measure_failure_demotes_to_the_cost_model(
        cfg, tiny_cfg, tmp_path):
    """``latency.measure:raise@0`` on a refreshed measurement with a
    cached entry: the breaker opens, the entry is quarantined, this call
    and the next return the cost-model table (the reference's, number for
    number), nothing is timed; equal counts and breakers."""
    env = InferenceEnv(hw=HW, batch=4, seq=32, mode="prefill")
    ref_env = RefEnv(batch=4, seq=32, mode="prefill", hw=TPU_V5E)
    tables, reps = [], []
    for pkg, stats, name in ((P, latency.TIMING_STATS, "port"),
                             (R, ref_latency.TIMING_STATS, "ref")):
        d = str(tmp_path / name)
        if pkg is P:
            LatencyCache(d).put(cfg, env, build_costmodel_table(cfg, env),
                                "cpu", **MEASURE_KW)
            measure = lambda **kw: build_table(    # noqa: E731
                cfg, env, "measure", device="cpu", cache_dir=d, **kw)
        else:
            RefLatencyCache(d).put(
                tiny_cfg, ref_env,
                ref_latency.build_costmodel_table(tiny_cfg, ref_env),
                **MEASURE_KW)
            measure = lambda **kw: ref_latency.build_table(  # noqa: E731
                tiny_cfg, ref_env, "measure", cache_dir=d, **kw)
        with pkg.install(pkg.FaultPlan.parse("latency.measure:raise@0")), \
                pkg.report_scope() as rep:
            t1 = measure(refresh=True, **MEASURE_KW)
            assert rep.breaker_open("latency.measure")
            assert [f for f in os.listdir(d) if f.endswith(".corrupt")]
            before = stats["reps"]
            t2 = measure(**MEASURE_KW)                # short-circuited
            assert stats["reps"] == before
        tables.append((t1, t2))
        summary = rep.as_dict()
        reps.append((_counts(rep), summary["breakers_open"],
                     len(summary["quarantined"])))
    assert reps[0] == reps[1]
    assert reps[0][0]["demotions"] == {"latency.measure": 1}
    (p1, p2), (r1, _) = tables
    for tab in (p1, p2):
        assert tab.base == r1.base and sorted(tab.times) == sorted(r1.times)
        for k in r1.times:
            np.testing.assert_array_equal(tab.times[k], r1.times[k])


def test_only_injected_faults_and_oom_demote_the_measurement(
        cfg, tmp_path, monkeypatch):
    """A RuntimeError of the measurement itself (say, a failed CUDA graph
    capture) raises and quarantines nothing; an out-of-memory error
    demotes; an env with no HardwareSpec has no cost model to demote to
    and raises a ValueError chained to the injected fault."""
    env = InferenceEnv(hw=HW, batch=4, seq=32, mode="prefill")
    d = str(tmp_path)
    path = LatencyCache(d).put(cfg, env, build_costmodel_table(cfg, env),
                               "cpu", **MEASURE_KW)

    def failing(exc):
        def time_fn(*args, **kw):
            raise exc
        return time_fn

    monkeypatch.setattr(latency, "_time_fn",
                        failing(RuntimeError("graph capture failed")))
    with P.report_scope() as rep:
        with pytest.raises(RuntimeError, match="graph capture"):
            build_table(cfg, env, "measure", device="cpu", cache_dir=d,
                        refresh=True, **MEASURE_KW)
    assert rep.total("demotions") == 0 and os.path.exists(path)

    monkeypatch.setattr(latency, "_time_fn",
                        failing(torch.cuda.OutOfMemoryError("out of memory")))
    with P.report_scope() as rep:
        tab = build_table(cfg, env, "measure", device="cpu", cache_dir=d,
                          refresh=True, **MEASURE_KW)
    assert tab.base == build_costmodel_table(cfg, env).base
    assert rep.counts["demotions"] == {"latency.measure": 1}
    assert not os.path.exists(path)
    monkeypatch.undo()

    with P.install(P.FaultPlan.parse("latency.measure:raise@0")), \
            P.report_scope() as rep:
        with pytest.raises(ValueError, match="no HardwareSpec") as ei:
            build_table(cfg, env.replace(hw=None), "measure", device="cpu",
                        **MEASURE_KW)
    assert isinstance(ei.value.__cause__, P.FaultInjected)
    assert rep.total("demotions") == 0


# ----------------------------------------------------------------------
# spdy.batched_eval
# ----------------------------------------------------------------------

def _ref_db_as_port(ref_db):
    return {name: ModuleDB(
        mod=PrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for name, m in ref_db.items()}


def _toy_eval(pkg):
    """A population scorer through ``pkg``'s site (the sum of the
    levels), and its one-candidate twin."""
    def eval_batched(assigns):
        pkg.hit("spdy.batched_eval")
        return np.asarray([float(sum(a.values())) for a in assigns])
    return (lambda a: float(sum(a.values()))), eval_batched


def test_batched_eval_failure_scores_serially(cfg, params, calib, db):
    """``spdy.batched_eval:raise@0`` in ``make_batched_eval``: the search
    scores the round and every later one serially and returns the clean
    batched search's assignment and score, bit for bit."""
    table = build_costmodel_table(cfg, ENV)
    cache = SnapshotCache(cfg, db, device="cpu")
    loss = calib_loss_fn(cfg, calib[:1], device="cpu")
    kw = dict(steps=12, pop=4, seed=0, batched=True,
              eval_fn=lambda a: loss(cache.apply(params, a)),
              eval_batched=make_batched_eval(cfg, params, cache, calib[:1],
                                             device="cpu"))
    clean = search(db, table, 1.5, **kw)
    with P.install(P.FaultPlan.parse("spdy.batched_eval:raise@0")), \
            P.report_scope() as rep:
        got = search(db, table, 1.5, **kw)
    assert got.assignment == clean.assignment and got.score == clean.score
    assert got.n_evals == clean.n_evals
    assert rep.counts["demotions"] == {"spdy.batched_eval": 1}
    assert rep.counts["injected"] == {"spdy.batched_eval": 1}


def test_batched_eval_demotion_and_its_limits_against_the_reference(
        tiny_cfg, tiny_params, ref):
    """Under one plan the two packages' searches on the reference's
    database demote once and agree; a non-injected error propagates in
    the port (the reference demotes on it), and an out-of-memory error
    demotes."""
    ref_db = ref_build_database(tiny_cfg, tiny_params, ref["hess"])
    ref_table = ref_latency.build_costmodel_table(
        tiny_cfg, RefEnv(hw=TPU_V5E, **ENV_KW))
    port_db = _ref_db_as_port(ref_db)
    table = latency.LatencyTable(env=ENV, grids=dict(ref_table.grids),
                                 times=dict(ref_table.times),
                                 base=ref_table.base)
    kw = dict(steps=12, pop=4, seed=0, batched=True)
    out = []
    for pkg, fn, dbx, tab in ((P, search, port_db, table),
                              (R, ref_search, ref_db, ref_table)):
        eval_fn, eval_batched = _toy_eval(pkg)
        with pkg.install(pkg.FaultPlan.parse("spdy.batched_eval:raise@0")), \
                pkg.report_scope() as rep:
            res = fn(dbx, tab, 1.5, eval_fn=eval_fn,
                     eval_batched=eval_batched, **kw)
        out.append((res.assignment, res.score, _counts(rep)))
    assert out[0] == out[1]

    def broken(assigns):
        raise RuntimeError("a kernel failed")

    def oom(assigns):
        raise torch.cuda.OutOfMemoryError("out of memory")

    eval_fn, _ = _toy_eval(P)
    with P.report_scope() as rep:
        with pytest.raises(RuntimeError, match="a kernel failed"):
            search(port_db, table, 1.5, eval_fn=eval_fn,
                   eval_batched=broken, **kw)
        assert rep.total("demotions") == 0
        res = search(port_db, table, 1.5, eval_fn=eval_fn, eval_batched=oom,
                     **kw)
    assert rep.counts["demotions"] == {"spdy.batched_eval": 1}
    assert res.assignment == out[0][0]


@pytest.mark.parametrize("rung", ["spdy.batched_eval", "latency.measure"])
def test_a_kernel_fault_inside_a_rung_raises_undemoted(
        rung, cfg, params, calib, db, tmp_path, monkeypatch):
    """A rung absorbs only a fault injected at its own site: a
    ``kernel.pallas:raise@0`` that fires inside the batched scorer's
    forward (flash attention runs there with ``attn_impl="flash_lax"``)
    or inside a timed module propagates, with no breaker and no
    demotion."""
    with P.install(P.FaultPlan.parse("kernel.pallas:raise@0")), \
            P.report_scope() as rep:
        with pytest.raises(P.FaultInjected, match="kernel.pallas") as ei:
            if rung == "spdy.batched_eval":
                fcfg = cfg.replace(attn_impl="flash_lax")
                cache = SnapshotCache(fcfg, db, device="cpu")
                search(db, build_costmodel_table(fcfg, ENV), 1.5, steps=4,
                       pop=4, seed=0, batched=True,
                       eval_batched=make_batched_eval(
                           fcfg, params, cache, calib[:1], device="cpu"))
            else:
                time_fn = latency._time_fn

                def kernel_in_module(*args, **kw):
                    faults.hit("kernel.pallas")
                    return time_fn(*args, **kw)

                monkeypatch.setattr(latency, "_time_fn", kernel_in_module)
                env = InferenceEnv(hw=HW, batch=4, seq=32, mode="prefill")
                build_table(cfg, env, "measure", device="cpu",
                            cache_dir=str(tmp_path), **MEASURE_KW)
    assert ei.value.site == "kernel.pallas"
    assert rep.total("demotions") == 0 and not rep.breaker_open(rung)
    assert _counts(rep) == {"injected": {"kernel.pallas": 1}}
    assert not os.listdir(tmp_path)


# ----------------------------------------------------------------------
# train.step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["two_nan_steps", "no_progress"])
def test_trainer_guard_counts_as_the_reference(case, cfg, tiny_cfg,
                                               tiny_params, tmp_path):
    """The loss guard under scripted losses (a ``step_fn`` stands in for
    the model in both packages): the same skipped steps, reloads and
    ``train.step`` counts."""
    nan = float("nan")
    script = [2.0, 2.0, nan, nan, 2.0, 2.0, 2.0] if case == "two_nan_steps" \
        else [2.0] + [nan] * 20
    got = []
    for pkg in (P, R):
        losses = iter(script)
        if pkg is P:
            def step_fn(state, batch):
                return state._replace(step=state.step + 1), \
                    {"loss": torch.tensor(next(losses))}
            tr = Trainer(cfg, TrainConfig(), ckpt_dir=str(tmp_path / "p"),
                         device="cpu", step_fn=step_fn, ckpt_every=100,
                         max_bad_steps=2)
            state = tr.init_or_restore(model_init(cfg, device="cpu"))
        else:
            def step_fn(state, batch):
                return state._replace(step=state.step + 1), \
                    {"loss": jnp.float32(next(losses))}
            tr = RefTrainer(tiny_cfg, RefTrainConfig(),
                            ckpt_dir=str(tmp_path / "r"), step_fn=step_fn,
                            ckpt_every=100, max_bad_steps=2)
            state = tr.init_or_restore(tiny_params)
        with pkg.report_scope() as rep:
            if case == "two_nan_steps":
                state = tr.fit(state, iter(range(100)), steps=5)
                assert int(state.step) == 5
            else:
                with pytest.raises(RuntimeError, match="cannot progress"):
                    tr.fit(state, iter(range(100)), steps=5)
        tr.ckpt.close()
        got.append((dict(tr.guard), _counts(rep)))
    assert got[0] == got[1]
    assert got[0][1]["detected"]["train.step"] >= 2


# ----------------------------------------------------------------------
# serve.step
# ----------------------------------------------------------------------

class _Successor:
    """A serving adapter without weights for either package's engine:
    the next token is ``(token + 1) % vocab``; ``array`` makes its
    logits and cache leaves (numpy for the reference, torch for the
    port)."""

    def __init__(self, array, vocab=17, max_len=MAX_LEN):
        self.array, self.vocab, self.max_len = array, vocab, max_len
        self.device = "cpu"

    def _logits(self, toks):
        lg = np.zeros((len(toks), 1, self.vocab), np.float32)
        lg[np.arange(len(toks)), 0, (np.asarray(toks) + 1) % self.vocab] = 1
        return self.array(lg)

    def init_slots(self, nslots):
        return {"attn": {"k": self.array(np.zeros(4, np.float32))},
                "pos": np.zeros(nslots, np.int64)}

    def prefill(self, tokens):
        return self._logits([tokens[-1]]), None

    def insert(self, cache, row, slot, pos):
        return cache

    def step(self, cache, tokens):
        toks = np.asarray(tokens).reshape(-1)
        return self._logits(toks), {**cache, "pos": cache["pos"] + 1}


def test_serve_step_retries_as_the_reference(cfg, tiny_cfg):
    """``serve.step:nan@2,serve.step:raise@4`` through both engines on the
    weightless adapter: the clean tokens and equal counts; four failures
    in a row raise."""
    reqs = synthetic_requests(cfg, 4, seed=3, rate=300.0,
                              prompt_lens=(5, 9), steps_range=(4, 8))
    ref_reqs = ref_synthetic_requests(tiny_cfg, 4, seed=3, rate=300.0,
                                      prompt_lens=(5, 9), steps_range=(4, 8))
    got = []
    for pkg, eng_cls, array, rq in (
            (P, ServeEngine, torch.from_numpy, reqs),
            (R, RefServeEngine, np.asarray, ref_reqs)):
        clean = [r.tokens for r in
                 eng_cls(_Successor(array), num_slots=2).run(rq).records]
        with pkg.install(pkg.FaultPlan.parse(
                "serve.step:nan@2,serve.step:raise@4")), \
                pkg.report_scope() as rep:
            served = [r.tokens for r in
                      eng_cls(_Successor(array), num_slots=2).run(rq).records]
        assert served == clean
        with pkg.install(pkg.FaultPlan.parse("serve.step:raise@0x4")), \
                pkg.report_scope():
            with pytest.raises(RuntimeError, match="serve.step"):
                eng_cls(_Successor(array), num_slots=2).run(rq)
        got.append((served, _counts(rep)))
    assert got[0] == got[1]
    assert got[0][1] == {"injected": {"serve.step": 2},
                         "detected": {"serve.step": 2},
                         "retries": {"serve.step": 2},
                         "recovered": {"serve.step": 2}}


@pytest.mark.parametrize("member", ["dense", "pruned"])
def test_recomputed_decode_steps_give_the_clean_tokens_and_cache(
        member, cfg, params, db):
    """On the port's models, whose caches are updated in place, a step
    recomputed after a NaN and after a raise writes what the clean step
    wrote: the same tokens and, after the stream, the same cache bits."""
    reqs = synthetic_requests(cfg, 5, seed=3, rate=300.0,
                              prompt_lens=(5, 9, 13), steps_range=(3, 8))

    def model():
        if member == "dense":
            return DenseServeModel(cfg, params, MAX_LEN)
        assignment = {n: int(m.levels[1]) for n, m in db.items()}
        return PrunedServeModel(shrink(cfg, params, db, assignment,
                                       device="cpu"), MAX_LEN)

    # a scripted clock (one tick a step): on the wall clock the retried
    # steps take longer, later arrivals join at other steps, and the idle
    # slots' positions at the end differ from the clean run's
    clean = ServeEngine(model(), num_slots=2, clock=_ticks())
    want = [r.tokens for r in clean.run(reqs).records]
    eng = ServeEngine(model(), num_slots=2, clock=_ticks())
    with P.install(P.FaultPlan.parse("serve.step:nan@2,serve.step:raise@4")), \
            P.report_scope() as rep:
        got = [r.tokens for r in eng.run(reqs).records]
    assert got == want
    assert rep.counts["recovered"] == {"serve.step": 2}
    a, b = _cache_leaves(clean.cache), _cache_leaves(eng.cache)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _ticks():
    """A clock that advances 1 ms at each read."""
    return itertools.count(0.0, 1e-3).__next__


def _cache_leaves(tree):
    """The tensors of a dense (dict) or pruned (per-layer list) cache."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _cache_leaves(t)]
    return [] if tree is None else [tree]


# ----------------------------------------------------------------------
# kernel.pallas: the port raises, the reference demotes
# ----------------------------------------------------------------------

def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    keep = torch.ones((1, 4))
    return {
        "hessian_accum": lambda: kernels.hessian_accum(r(16, 8)),
        "obs_downdate": lambda: kernels.obs_downdate(
            r(1, 4, 3), r(1, 4, 4), r(1, 4, 1), r(1, 1, 3), r(1, 1, 4),
            keep),
        "flash_attention": lambda: kernels.flash_attention(
            r(1, 4, 2, 8), r(1, 4, 2, 8), r(1, 4, 2, 8)),
        "ssd_intra_chunk": lambda: kernels.ssd_intra_chunk(
            r(1, 1, 4, 2, 3), r(1, 1, 4, 2), r(1, 1, 4, 5), r(1, 1, 4, 5)),
        "ssd_intra_chunk_backward": lambda: kernels.ssd_intra_chunk_backward(
            r(1, 1, 4, 2, 3), r(1, 1, 4, 2), r(1, 1, 4, 5), r(1, 1, 4, 5),
            r(1, 1, 4, 2, 3), r(1, 1, 2, 3, 5)),
    }


@pytest.mark.parametrize("name", [k.__name__ for k in kernels.KERNELS])
def test_injected_kernel_failure_raises_out_of_the_wrapper(name):
    call = _kernel_calls()[name]
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    with P.install(P.FaultPlan.parse("kernel.pallas:raise@0")), \
            P.report_scope() as rep:
        with pytest.raises(P.FaultInjected, match="kernel.pallas"):
            call()
        call()                                     # hit 1: it runs
    assert _counts(rep) == {"injected": {"kernel.pallas": 1}}
    assert not rep.as_dict()["breakers_open"]
    assert {k.__name__: k.launches for k in kernels.KERNELS} == launches


def test_oneshot_prune_raises_where_the_reference_demotes(cfg, params,
                                                          calib):
    with P.install(P.FaultPlan.parse("kernel.pallas:raise@0")), \
            P.report_scope() as rep:
        with pytest.raises(P.FaultInjected):
            oneshot_prune(cfg, params, calib, ENV, [1.5], search_steps=4,
                          device="cpu")
    assert rep.total("demotions") == 0
    x = jnp.asarray(np.random.default_rng(0).standard_normal((16, 8)),
                    jnp.float32)
    with R.install(R.FaultPlan.parse("kernel.pallas:raise@0")), \
            R.report_scope() as ref_rep:
        h = ref_ops.hessian_accum(x)
    np.testing.assert_allclose(np.asarray(h), np.asarray(x.T @ x),
                               atol=1e-4, rtol=1e-5)
    assert ref_rep.counts["demotions"] == {"kernel.pallas:hessian_accum": 1}


# ----------------------------------------------------------------------
# fault-free bit-identity, and a faulted family
# ----------------------------------------------------------------------

def test_oneshot_prune_under_an_armed_plan_is_bit_identical(cfg, params,
                                                            calib):
    kw = dict(search_steps=8, search_pop=4, seed=0, device="cpu")
    clean = oneshot_prune(cfg, params, calib, ENV, TARGETS, **kw)
    plan = P.FaultPlan.parse(ARMED)
    with P.install(plan), P.report_scope() as rep:
        armed = oneshot_prune(cfg, params, calib, ENV, TARGETS, **kw)
    assert plan.hits["kernel.pallas"] > 0 and plan.hits["calib.batch"] == 3
    assert not plan.fired and not _counts(rep)
    for t in TARGETS:
        a, b = clean.variants[t], armed.variants[t]
        assert a.assignment == b.assignment and a.calib_loss == b.calib_loss
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a.params), tree_leaves(b.params)))


def _family(cfg, params, base, **extra):
    return gradual_prune(
        cfg, params, ENV, TARGETS,
        lambda step: synthetic_stream(cfg, 16, 64, seed=99, start_step=step),
        calibration_batches(cfg, 16, 64, batch=8), ckpt_dir=str(base),
        tcfg=TrainConfig(learning_rate=5e-4, warmup_steps=2,
                         total_steps=FT_STEPS, distill_logit=1.0,
                         distill_token=0.5),
        finetune_steps=FT_STEPS, search_steps=4, search_pop=4,
        ckpt_every=4, device="cpu", **extra)


@pytest.fixture(scope="module")
def clean_family(cfg, params, tmp_path_factory):
    return _family(cfg, params, tmp_path_factory.mktemp("clean"))


def _same_family(want, got):
    assert [v.target for v in got] == [v.target for v in want]
    for vw, vg in zip(want, got):
        assert vw.assignment == vg.assignment
        assert vw.loss_before_ft == vg.loss_before_ft
        assert vw.loss_after_ft == vg.loss_after_ft
        lw, lg = tree_leaves(vw.params), tree_leaves(vg.params)
        assert len(lw) == len(lg) and all(torch.equal(x, y)
                                          for x, y in zip(lw, lg))


def test_family_under_an_armed_plan_is_bit_identical(cfg, params, tmp_path,
                                                     clean_family):
    plan = P.FaultPlan.parse(ARMED)
    with P.install(plan):
        got = _family(cfg, params, tmp_path, report=P.RobustnessReport())
    _same_family(clean_family, got)
    assert plan.hits["db.artifact_write"] > 0 and not plan.fired
    path = os.path.join(family_run_dir(cfg, TARGETS, 0, str(tmp_path)),
                        "family.json")
    with open(path) as f:
        assert not any(json.load(f)["robustness"]["counts"].values())


def test_corrupt_artifact_and_failed_checkpoint_writes_heal(
        cfg, params, tmp_path, clean_family):
    """``db.artifact_write:corrupt@0,ckpt.async_write:oserror@0x2``: the
    first artifact (target 1.5's Hessians) is corrupted after its write;
    the run is killed after that stage, and the resume quarantines the
    file, calibrates again, heals the first checkpoint write on its third
    attempt, and gives the clean family bit for bit."""
    plan = P.FaultPlan.parse(
        "db.artifact_write:corrupt@0,ckpt.async_write:oserror@0x2")
    with P.install(plan):
        with pytest.raises(FamilyPreempted):
            _family(cfg, params, tmp_path, stop_after=(0, "hessians"))
        rep = P.RobustnessReport()
        got = _family(cfg, params, tmp_path, report=rep)
    _same_family(clean_family, got)
    assert [q.rsplit(os.sep, 2)[-2:] for q in rep.quarantined] == \
        [["t1.5", "hessians.npz.corrupt"]]
    assert rep.counts["injected"] == {"ckpt.async_write": 2}
    assert rep.counts["retries"] == {"ckpt.async_write": 2}
    assert rep.counts["recovered"] == {"ckpt.async_write": 1}
    assert rep.counts["detected"] == {"db.artifact_write": 1}
    rdir = family_run_dir(cfg, TARGETS, 0, str(tmp_path))
    with open(os.path.join(rdir, "family.json")) as f:
        man = json.load(f)
    assert man["robustness"] == rep.as_dict()
    assert ("1.5", "hessians") in [(e["target"], e["stage"])
                                   for e in man["executed"] if e["run"] == 2]
