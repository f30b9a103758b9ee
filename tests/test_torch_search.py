"""The port's serial SPDY search (``core/spdy.py`` ``dp_select`` and
``search_family(batched=False)``) against the JAX package's, and against
the port's own batched search, on the CPU.

The serial path runs the batched path's rounds, mutations and acceptance
with the scalar DP and candidates scored one by one, so on the analytic
score (no loss) both paths, and the reference's serial path on the same
database and table, give the same assignments, scores and histories bit
for bit. Scored by the calibration loss, a candidate's score is the same
forward either way: serial and batched scores agree to 1e-6 relative,
the reference's own invariant (tests/test_spdy_search.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.core import database as ref_database
from repro.core import latency as ref_latency
from repro.core import spdy as ref_spdy
from repro.core.structures import PrunableModule as RefPrunableModule
from repro.models import model_init as ref_model_init
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro_torch.configs import ModelConfig
from repro_torch.core import spdy
from repro_torch.core.latency import build_table
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.data import calibration_batches
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv

JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
REF_TINY = REF_GPT2.replace(name="gpt2-tiny", num_layers=2, d_model=96,
                            d_ff=384, num_heads=6, num_kv_heads=6,
                            head_dim=16, vocab_size=384, dtype="float32")
CFG = ModelConfig(**{k: v for k, v in dataclasses.asdict(REF_TINY).items()
                     if k not in JAX_EXECUTION})
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=16, seq=128, mode="prefill")
TARGETS = [1.5, 2.0, 3.0]
SEARCH_KW = dict(search_steps=32, search_pop=8, seed=0)


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
def params():
    ref_params = ref_model_init(REF_TINY, jax.random.key(0))[0]
    return params_from_numpy(jax.tree.map(np.asarray, ref_params),
                             device="cpu")


@pytest.fixture(scope="module")
def calib():
    return calibration_batches(CFG, 16, 64, batch=8)


def _oneshot(params, calib, **kw):
    return oneshot_prune(CFG, params, calib, InferenceEnv(hw=HW, **ENV_KW),
                         TARGETS, device="cpu", **SEARCH_KW, **kw)


@pytest.fixture(scope="module")
def analytic(params, calib):
    """The family on the analytic score, batched and serial."""
    return {b: _oneshot(params, calib, eval_with_loss=False,
                        search_batched=b) for b in (True, False)}


def _ref_db(db):
    """The port's database as the reference's ModuleDBs (same arrays)."""
    return {name: ref_database.ModuleDB(
        mod=RefPrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for name, m in db.items()}


def _ref_table(tab):
    return ref_latency.LatencyTable(env=RefEnv(hw=TPU_V5E, **ENV_KW),
                                    grids=dict(tab.grids),
                                    times=dict(tab.times), base=tab.base)


def _assert_same_results(got, want):
    for t in want:
        assert got[t].assignment == want[t].assignment, t
        assert got[t].score == want[t].score, t
        assert got[t].runtime == want[t].runtime, t
        assert got[t].history == want[t].history, t
        assert got[t].n_evals == want[t].n_evals, t


def _costs(rng, P=None):
    shape = (lambda k: (P, k)) if P else (lambda k: (k,))
    ks = (4, 7, 3, 9, 5)
    costs = [rng.random(shape(k)) for k in ks]
    times = [np.sort(rng.random(k))[::-1] for k in ks]
    return costs, times


@pytest.mark.parametrize("budget", [0.05, 0.3, 1.0, 2.5, 10.0])
@pytest.mark.parametrize("nbins", [16, 64, 1024])
def test_dp_select_matches_reference(budget, nbins):
    """Seeded costs and times; 0.05 leaves every budget infeasible."""
    costs, times = _costs(np.random.default_rng(2))
    got = spdy.dp_select(costs, times, budget, nbins)
    want = ref_spdy.dp_select(costs, times, budget, nbins)
    if want[0] is None:
        assert got[0] is None and got[1] == np.inf
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    tq = spdy.quantize_times(times, budget, nbins)
    assert sum(int(t[c]) for t, c in zip(tq, got[0])) <= nbins


@pytest.mark.parametrize("budget", [0.05, 0.3, 1.0, 2.5])
def test_dp_select_batched_equals_dp_select(budget):
    costs, times = _costs(np.random.default_rng(3), P=6)
    choices, totals = spdy.dp_select_batched(costs, times, budget, nbins=64)
    for p in range(6):
        one, total = spdy.dp_select([c[p] for c in costs], times, budget,
                                    nbins=64)
        if one is None:
            assert (choices[p] == -1).all() and totals[p] == np.inf
        else:
            np.testing.assert_array_equal(choices[p], one)
            assert totals[p] == total


def test_serial_search_equals_batched_and_reference(analytic):
    """On the analytic score: the serial search equals the batched one,
    and the reference's serial search on the same database and table."""
    res = analytic[True]
    db, table = res.db, res.table
    kw = dict(steps=32, pop=8, seed=5)
    serial = spdy.search_family(db, table, TARGETS, batched=False, **kw)
    _assert_same_results(serial, spdy.search_family(db, table, TARGETS,
                                                    **kw))
    _assert_same_results(serial, ref_spdy.search_family(
        _ref_db(db), _ref_table(table), TARGETS, batched=False, **kw))
    # search() is a one-target search_family, on both paths
    for batched in (True, False):
        one = spdy.search(db, table, 2.0, batched=batched, **kw)
        fam = spdy.search_family(db, table, [2.0], batched=batched, **kw)
        assert one.assignment == fam[2.0].assignment
        assert one.score == fam[2.0].score


def test_oneshot_serial_search_equals_batched_and_reference(analytic):
    """``oneshot_prune(search_batched=False, eval_with_loss=False)``: the
    batched run's family bit for bit, and the reference's serial search
    on the run's own database and table."""
    serial, batched = analytic[False], analytic[True]
    for name, mdb in batched.db.items():
        np.testing.assert_array_equal(serial.db[name].order, mdb.order)
    results = {t: v.search for t, v in serial.variants.items()}
    _assert_same_results(results, {t: v.search for t, v in
                                   batched.variants.items()})
    want = ref_spdy.search_family(_ref_db(serial.db),
                                  _ref_table(serial.table), TARGETS,
                                  steps=32, pop=8, seed=0, batched=False)
    _assert_same_results(results, want)
    for t, v in serial.variants.items():
        assert v.speedup >= t
        assert v.calib_loss == batched.variants[t].calib_loss


def test_serial_search_scored_by_the_loss_agrees_with_batched(params,
                                                              calib):
    """Scored by the calibration loss: the serial path's per-candidate
    ``eval_fn`` and the batched path's ``eval_batched`` give the same
    scores to 1e-6 relative, and every target is met."""
    serial = _oneshot(params, calib, search_batched=False)
    batched = _oneshot(params, calib)
    for t in TARGETS:
        s, b = serial.variants[t], batched.variants[t]
        assert s.speedup >= t and b.speedup >= t
        np.testing.assert_allclose(s.search.score, b.search.score,
                                   rtol=1e-6)
        np.testing.assert_allclose(s.search.history, b.search.history,
                                   rtol=1e-6)
        assert s.assignment == b.assignment


def test_serial_search_scores_each_candidate_with_eval_fn(analytic):
    """``batched=False`` scores every new candidate with ``eval_fn``, one
    call each, and never calls ``eval_batched``; the batched path calls
    ``eval_batched`` once a round."""
    db, table = analytic[True].db, analytic[True].table
    calls = {"fn": 0, "batched": 0}

    def eval_fn(a):
        calls["fn"] += 1
        return float(sum(a.values()))

    def eval_batched(al):
        calls["batched"] += 1
        return np.asarray([float(sum(a.values())) for a in al])

    kw = dict(steps=24, pop=8, seed=1, eval_fn=eval_fn,
              eval_batched=eval_batched)
    serial = spdy.search_family(db, table, TARGETS, batched=False, **kw)
    assert calls == {"fn": serial[TARGETS[0]].n_evals, "batched": 0}
    calls.update(fn=0, batched=0)
    batched = spdy.search_family(db, table, TARGETS, **kw)
    assert calls == {"fn": 0, "batched": 3}
    _assert_same_results(serial, batched)


def test_costmodel_table_is_the_reference_table(analytic):
    """The table both searches above run on is the reference's."""
    got = build_table(CFG, InferenceEnv(hw=HW, **ENV_KW), device="cpu")
    want = ref_latency.build_table(REF_TINY, RefEnv(hw=TPU_V5E, **ENV_KW))
    for kind in want.grids:
        np.testing.assert_array_equal(got.times[kind], want.times[kind])
        np.testing.assert_array_equal(analytic[True].table.times[kind],
                                      want.times[kind])
    assert got.base == want.base
