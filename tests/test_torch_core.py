"""The port's one-shot slice against the JAX package, stage by stage, on
the same weights (moved over by the weight bridge) and the same numpy
calibration tokens. Each stage is fed the reference's own output of the
stage before it, so a mismatch points at one stage:

* calibration: Hessians and per-module counts, and a poisoned batch;
* database: built from the reference's Hessians — identical removal
  orders, snapshots within fp16 tolerance, errors close; the port's
  batched build equals its serial build;
* latency: the cost-model table priced with the reference's TPU_V5E
  fields, number for number;
* SPDY: the reference's database, table and seed give identical
  assignments;
* the slice: ``oneshot_prune`` end to end.

Tolerances: Hessians are fp32 sums taken in different orders (1e-5
relative to the largest entry); snapshots are float16 (2e-3, as in
tests/test_batched_db.py); errors and priors 1e-3 relative against the
reference (the two start from inverses of the same Hessian that differ
by cond(H)·eps, ~1e-5 here, and the difference grows along the run to
~1.5e-4 at the last levels) and 1e-4 between the port's own batched and
serial builds; losses of the same stitched assignment 1e-4 relative
(fp16 snapshots on both sides).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.core import database as ref_database
from repro.core import oneshot as ref_oneshot
from repro.core import spdy as ref_spdy
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.latency import build_table as ref_build_table
from repro.core.structures import level_grid as ref_level_grid
from repro.core.structures import registry as ref_registry
from repro.data import calibration_batches as ref_calibration_batches
from repro.models import model_init as ref_model_init
from repro.robustness import FaultPlan, install
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro_torch.configs import ModelConfig
from repro_torch.core import database, hessian, spdy
from repro_torch.core.latency import LatencyTable, build_table
from repro_torch.core.obs import (build_hessian, module_drop_error,
                                  module_drop_errors, prune_structured,
                                  prune_structured_batched)
from repro_torch.core.oneshot import calib_loss_fn, oneshot_prune
from repro_torch.core.structures import PrunableModule, level_grid, registry
from repro_torch.data import calibration_batches
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv

# the JAX package's tracing and tiling options, which the port's config
# does not carry
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(ref_cfg):
    """The port's config of a reference config, field for field."""
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


# the quickstart's gpt2-tiny (examples/quickstart.py), two layers, fp32
REF_TINY = REF_GPT2.replace(name="gpt2-tiny", num_layers=2, d_model=96,
                            d_ff=384, num_heads=6, num_kv_heads=6,
                            head_dim=16, vocab_size=384, dtype="float32")
CFG = port_cfg(REF_TINY)
# the reference's TPU_V5E fields in a port HardwareSpec
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=16, seq=128, mode="prefill")
TARGETS = [1.5, 2.0, 3.0]


@pytest.fixture(scope="module")
def ref():
    """Reference weights, calibration batches, Hessians and database."""
    params = ref_model_init(REF_TINY, jax.random.key(0))[0]
    calib = ref_calibration_batches(REF_TINY, 24, 64, batch=8)
    hess = ref_collect_hessians(REF_TINY, params, calib)
    db = ref_database.build_database(REF_TINY, params, hess)
    return {"params": params, "calib": calib, "hess": hess, "db": db}


@pytest.fixture(scope="module")
def port_params(ref):
    return params_from_numpy(jax.tree.map(np.asarray, ref["params"]),
                             device="cpu")


def _port_hessians(ref):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in ref["hess"].items()}


def _port_db(ref_db):
    """The reference's database as port ModuleDBs (same arrays)."""
    return {name: database.ModuleDB(
        mod=PrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for name, m in ref_db.items()}


def _port_table(ref_tab):
    return LatencyTable(env=InferenceEnv(hw=HW, **ENV_KW),
                        grids=dict(ref_tab.grids), times=dict(ref_tab.times),
                        base=ref_tab.base)


def test_registry_and_level_grids_match_reference():
    ref_mods = ref_registry(REF_TINY)
    mods = registry(CFG)
    assert [dataclasses.asdict(m) for m in mods] == \
        [dataclasses.asdict(m) for m in ref_mods]
    for m, rm in zip(mods, ref_mods):
        assert level_grid(m) == ref_level_grid(rm)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_hessians_match_reference(ref, port_params):
    calib = calibration_batches(CFG, 24, 64, batch=8)
    got = hessian.collect_hessians(CFG, port_params, calib, device="cpu")
    assert list(got) == list(ref["hess"])
    for name, want in ref["hess"].items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_poisoned_batch_gives_clean_run_minus_that_batch(ref, port_params,
                                                         monkeypatch, capsys):
    calib = calibration_batches(CFG, 24, 64, batch=8)
    clean = hessian.collect_hessians(CFG, port_params, [calib[0], calib[2]],
                                     device="cpu")
    real_forward = hessian.forward
    calls = []

    def poisoned(cfg, params, tokens, *, capture):
        out = real_forward(cfg, params, tokens, capture=capture)
        calls.append(1)
        if len(calls) == 2:  # the second batch: one NaN in one capture
            out["captures"]["ffn"]["wd_in"][0, 0, 3, 5] = float("nan")
        return out

    monkeypatch.setattr(hessian, "forward", poisoned)
    got = hessian.collect_hessians(CFG, port_params, calib, device="cpu")
    assert "skipped 1/3" in capsys.readouterr().out
    with install(FaultPlan.parse("calib.batch:nan@1")):
        want = ref_collect_hessians(REF_TINY, ref["params"],
                                    ref["calib"])
    for name in clean:
        # bit-identical to the clean run: the poisoned batch is a no-op
        np.testing.assert_array_equal(got[name].numpy(), clean[name].numpy())
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_every_batch_poisoned_raises(port_params, monkeypatch):
    real_forward = hessian.forward

    def poisoned(cfg, params, tokens, *, capture):
        out = real_forward(cfg, params, tokens, capture=capture)
        out["captures"]["attn"]["wo_in"].fill_(float("inf"))
        return out

    monkeypatch.setattr(hessian, "forward", poisoned)
    with pytest.raises(FloatingPointError, match="every calibration"):
        hessian.collect_hessians(CFG, port_params,
                                 calibration_batches(CFG, 16, 64, batch=8),
                                 device="cpu")


# ---------------------------------------------------------------------------
# database
# ---------------------------------------------------------------------------

def _assert_db_close(got, want, err_rtol=1e-3):
    assert list(got) == list(want)  # registry order
    for name, w in want.items():
        g = got[name]
        np.testing.assert_array_equal(g.levels, w.levels)
        np.testing.assert_array_equal(g.order, w.order, err_msg=name)
        np.testing.assert_allclose(g.errors, w.errors, rtol=err_rtol,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g.priors, w.priors, rtol=err_rtol,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.snapshots.astype(np.float32),
                                   w.snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=name)
        assert np.isclose(g.base_norm, w.base_norm, rtol=1e-5)


@pytest.fixture(scope="module")
def port_db(ref, port_params):
    return database.build_database(CFG, port_params, _port_hessians(ref),
                                   device="cpu")


def test_database_matches_reference(ref, port_db):
    _assert_db_close(port_db, ref["db"])


@pytest.mark.parametrize("max_batch", [16, 1])
def test_batched_database_equals_serial(ref, port_params, port_db,
                                        max_batch):
    serial = database.build_database(CFG, port_params, _port_hessians(ref),
                                     batched=False, device="cpu")
    if max_batch == 16:
        batched = port_db
    else:
        batched = database.build_database(CFG, port_params,
                                          _port_hessians(ref),
                                          max_batch=max_batch, device="cpu")
    _assert_db_close(batched, serial, err_rtol=1e-4)


def test_module_drop_errors_match_per_module(ref, port_params):
    hess = _port_hessians(ref)
    mods = [m for m in registry(CFG) if m.kind == "ffn"]
    Ws = torch.stack([database.get_matrix(CFG, port_params, m) for m in mods])
    Hs = torch.stack([hess[m.name] for m in mods])
    batched = module_drop_errors(Ws, Hs)
    for i, m in enumerate(mods):
        torch.testing.assert_close(batched[i], module_drop_error(Ws[i], Hs[i]),
                                   rtol=1e-5, atol=0)


def test_prune_structured_is_the_batched_core_for_one_module(ref,
                                                            port_params):
    mod = registry(CFG)[0]  # attention: group_size 16, the Cholesky branch
    W = database.get_matrix(CFG, port_params, mod)
    Hinv = torch.linalg.inv(build_hessian(_port_hessians(ref)[mod.name]))
    lv = tuple(level_grid(mod))
    one = prune_structured(W, Hinv, group_size=mod.group_size,
                           n_remove=max(lv), levels=lv)
    many = prune_structured_batched(W[None], Hinv[None],
                                    group_size=mod.group_size,
                                    n_remove=max(lv), levels=lv)
    assert one.perm is None and many.perm is None  # compacted runs only
    for a, b in zip(one[:3], many[:3]):
        assert torch.equal(a, b[0])


def test_snapshot_cache_matches_host_stitch(ref, port_params, port_db):
    cache = database.SnapshotCache(CFG, port_db, device="cpu")
    rng = np.random.default_rng(0)
    assigns = [{n: int(rng.choice(m.levels)) for n, m in port_db.items()}
               for _ in range(3)]
    for a in assigns:
        want = database.apply_assignment(CFG, port_params, port_db, a)
        got = cache.apply(port_params, a)
        for grp, leaf in (("attn", "wo"), ("ffn", "wd")):
            assert torch.equal(got["layers"][grp][leaf],
                               want["layers"][grp][leaf])
    # the given tree is never written
    assert torch.equal(port_params["layers"]["ffn"]["wd"],
                       params_from_numpy(jax.tree.map(
                           np.asarray, ref["params"]),
                           device="cpu")["layers"]["ffn"]["wd"])


def test_apply_batched_matches_reference(ref, port_params):
    """Stitched from the reference's own database, the port's stacked
    leaves equal the reference's, member by member."""
    rng = np.random.default_rng(1)
    assigns = [{n: int(rng.choice(m.levels)) for n, m in ref["db"].items()}
               for _ in range(3)]
    got = database.SnapshotCache(CFG, _port_db(ref["db"]), device="cpu") \
        .apply_batched(port_params, assigns)
    want = ref_database.SnapshotCache(REF_TINY, ref["db"]) \
        .apply_batched(ref["params"], assigns)
    for grp, leaf in (("attn", "wo"), ("ffn", "wd")):
        g = got["layers"][grp][leaf]
        assert g.shape[0] == len(assigns)
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(want["layers"][grp][leaf]))


@pytest.mark.parametrize("name", ["L0.attn", "L1.ffn"])
def test_algorithm1_from_the_reference_inverse_keeps_its_order(
        ref, port_params, name):
    """Started from the reference's own fp32 inverse, the port's
    Algorithm 1 removes structures in the reference's order, with
    snapshots and errors at the database tolerances: where the two
    packages' orders could part, it is the starting inverse, not the
    steps. L1.ffn (cond ~2e4) is where an fp32 inverse taken by the port
    itself swapped two near-tied removals."""
    from repro.core import obs as ref_obs
    mod = next(m for m in registry(CFG) if m.name == name)
    lv = tuple(level_grid(mod))
    W = database.get_matrix(CFG, port_params, mod)
    h = np.asarray(ref["hess"][name])
    hinv = jax.numpy.linalg.inv(ref_obs.build_hessian(jax.numpy.asarray(h)))
    want = ref_obs.prune_structured(jax.numpy.asarray(W.numpy()), hinv,
                                    group_size=mod.group_size,
                                    n_remove=max(lv), levels=lv)
    got = prune_structured(W, torch.from_numpy(np.array(hinv)),
                           group_size=mod.group_size, n_remove=max(lv),
                           levels=lv)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_allclose(got.snapshots.float().numpy(),
                               np.asarray(want.snapshots, np.float32),
                               atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# latency and search
# ---------------------------------------------------------------------------

def test_costmodel_table_matches_reference():
    want = ref_build_table(REF_TINY, RefEnv(hw=TPU_V5E, **ENV_KW))
    got = build_table(CFG, InferenceEnv(hw=HW, **ENV_KW), device="cpu")
    assert sorted(got.grids) == sorted(want.grids)
    for kind in want.grids:
        np.testing.assert_array_equal(got.grids[kind], want.grids[kind])
        np.testing.assert_array_equal(got.times[kind], want.times[kind])
    assert got.base == want.base
    mods = registry(CFG)
    assert got.dense_runtime(mods) == want.dense_runtime(ref_registry(REF_TINY))


def test_costmodel_needs_a_hardware_spec():
    with pytest.raises(ValueError, match="HardwareSpec"):
        build_table(CFG, InferenceEnv(hw=None, **ENV_KW), device="cpu")


def test_spdy_assignments_match_reference(ref):
    ref_tab = ref_build_table(REF_TINY, RefEnv(hw=TPU_V5E, **ENV_KW))
    want = ref_spdy.search_family(ref["db"], ref_tab, TARGETS, steps=64,
                                  pop=16, seed=3)
    got = spdy.search_family(_port_db(ref["db"]), _port_table(ref_tab),
                             TARGETS, steps=64, pop=16, seed=3)
    for t in TARGETS:
        assert got[t].assignment == want[t].assignment
        assert got[t].score == want[t].score
        assert got[t].runtime == want[t].runtime
        assert got[t].history == want[t].history
        assert got[t].speedup >= t


def test_dp_select_batched_matches_reference():
    rng = np.random.default_rng(1)
    costs = [rng.random((5, k)) for k in (4, 7, 3, 9)]
    times = [np.sort(rng.random(k))[::-1] for k in (4, 7, 3, 9)]
    for budget in (0.3, 1.0, 2.5):
        tq = spdy.quantize_times(times, budget, 64)
        for a, b in zip(tq, ref_spdy.quantize_times(times, budget, 64)):
            np.testing.assert_array_equal(a, b)
        got = spdy.dp_select_batched(costs, times, budget, nbins=64)
        want = ref_spdy.dp_select_batched(costs, times, budget, nbins=64)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def test_oneshot_prune_end_to_end(ref, port_params):
    calib = calibration_batches(CFG, 24, 64, batch=8)
    res = oneshot_prune(CFG, port_params, calib, InferenceEnv(hw=HW, **ENV_KW),
                        TARGETS, search_steps=32, search_pop=16, seed=0,
                        device="cpu")
    _assert_db_close(res.db, ref["db"])
    assert set(res.stage_seconds) == {"calibration", "latency_table",
                                      "database", "search", "stitch"}
    ref_loss = ref_oneshot.calib_loss_fn(REF_TINY, ref["calib"][:1])
    np.testing.assert_allclose(res.dense_loss, ref_loss(ref["params"]),
                               rtol=1e-5)
    for t in TARGETS:
        v = res.variants[t]
        assert v.speedup >= t
        assert v.runtime <= res.dense_runtime / t
        assert res.table.runtime_of(v.assignment, registry(CFG)) == \
            pytest.approx(v.runtime, rel=1e-12)
        stitched = ref_database.apply_assignment(REF_TINY, ref["params"],
                                                 ref["db"], v.assignment)
        np.testing.assert_allclose(v.calib_loss, ref_loss(stitched),
                                   rtol=1e-4, err_msg=f"{t}x")
        # the member's params are the stitched assignment
        again = database.apply_assignment(CFG, port_params, res.db,
                                          v.assignment)
        assert torch.equal(v.params["layers"]["ffn"]["wd"],
                           again["layers"]["ffn"]["wd"])
    # the family scorer is the loss of each stitched candidate
    loss = calib_loss_fn(CFG, calib[:1], device="cpu")
    v = res.variants[TARGETS[0]]
    assert loss(v.params) == pytest.approx(v.calib_loss, rel=1e-6)


@pytest.mark.parametrize("n_groups,gs,seed", [(3, 2, 3994), (2, 1, 7),
                                              (5, 3, 123), (4, 2, 9000)])
def test_damping_ladder_converges_near_singular(n_groups, gs, seed):
    """Some rung of the ladder gives an entirely finite prune of a rank-1
    Hessian from an absurdly small base damp (the invariant
    ``_prune_healed`` relies on). (3, 2, 3994) is the example the JAX
    package's own property test records as failing there."""
    rng = np.random.default_rng(seed)
    d_in = n_groups * gs
    v = rng.standard_normal((1, d_in))
    xtx = torch.from_numpy((v.T @ v).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((d_in, 4)).astype(np.float32))
    for damp in database.damp_schedule(1e-10, retries=6):
        Hinv = database._inverse_or_nan(build_hessian(xtx, damp))
        if not bool(torch.isfinite(Hinv).all()):
            continue
        res = prune_structured(W, Hinv, group_size=gs, n_remove=n_groups,
                               levels=tuple(range(n_groups + 1)))
        if bool(torch.isfinite(res.errors).all()
                and torch.isfinite(res.snapshots.float()).all()):
            return
    raise AssertionError("no damping rung produced a finite prune")


def test_damping_ladder_names_the_module_and_level_that_failed(capsys):
    """A failed rung names the failing module of a stack and the level
    its prune went non-finite at; the healthy module is not named."""
    rng = np.random.default_rng(123)
    n_groups, gs = 5, 3
    d_in = n_groups * gs
    v = rng.standard_normal((1, d_in))
    x = rng.standard_normal((64, d_in))
    xtx = torch.from_numpy(np.stack([v.T @ v, x.T @ x]).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((2, d_in, 4)).astype(np.float32))
    lv = tuple(range(n_groups + 1))
    snaps, errs, _ = database._prune_healed(
        prune_structured_batched, W, xtx, group_size=gs, n_remove=n_groups,
        levels=lv, damp=1e-10, names=["rank1", "healthy"])
    out = capsys.readouterr().out
    assert ("non-finite prune at damp=1e-10 in 1 of 2 module(s): rank1 "
            "error from level 1 (removal 1)") in out
    assert "healthy" not in out
    assert "healed non-finite prune" in out
    assert np.isfinite(errs).all() and np.isfinite(snaps).all()


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_a_non_finite_snapshot_is_named_at_its_first_level(bad):
    """The snapshots' finite check, made where they are, names the module
    and the first level whose float16 snapshot holds a non-finite value,
    for a serial (levels, d_in, d_out) and a stacked result alike."""
    levels = (0, 1, 3, 6)
    snaps = torch.zeros((2, len(levels), 6, 4), dtype=torch.float16)
    snaps[1, 2, 5, 3] = bad
    snaps[1, 3, 0, 0] = bad
    errs = np.zeros((2, len(levels)), np.float32)
    ok = database._finite_snapshots(snaps, 2, len(levels))
    assert ok.tolist() == [[True] * 4, [True, True, False, False]]
    assert database._non_finite_report(["a", "b"], levels, errs, ok) == [
        "b float16 snapshot from level 3 (one of removals 2..3)"]
    assert database._finite_snapshots(snaps[1], 1, len(levels)).tolist() \
        == [[True, True, False, False]]
