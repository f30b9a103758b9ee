"""The port's live-set-compacted Algorithm-1 cores (``core/obs.py``
``prune_structured[_batched]_compact``) and ``build_database(compact=
True)`` against the JAX package's and against the port's plain cores, on
the CPU, on seeded numpy inputs.

The compacted core shares the plain core's step
(``_select_and_downdate``), so its removal orders are the plain core's.
Bounds are the reference's own (tests/test_obs.py): orders and ``perm``
identical, errors 1e-5 relative, float16 snapshots within 2e-3. Each
case first checks that its schedule has more than one segment, so the
compacted path is the one under test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.core import database as ref_database
from repro.core import obs as ref_obs
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.data import calibration_batches as ref_calibration_batches
from repro.models import model_init as ref_model_init
from repro_torch.configs import ModelConfig
from repro_torch.core import database, obs
from repro_torch.core.structures import level_grid, registry
from repro_torch.models.convert import params_from_numpy

JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
REF_TINY = REF_GPT2.replace(name="gpt2-tiny", num_layers=2, d_model=96,
                            d_ff=384, num_heads=6, num_kv_heads=6,
                            head_dim=16, vocab_size=384, dtype="float32")
CFG = ModelConfig(**{k: v for k, v in dataclasses.asdict(REF_TINY).items()
                     if k not in JAX_EXECUTION})
# the small cases' schedule options (the reference's tests/test_obs.py)
SMALL = dict(min_rows=16, pad_rows=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ffn_levels(n):
    """The 0.9^i grid of ``structures.level_grid`` for n scalar rows."""
    return tuple(sorted({n - int(np.ceil(n * 0.9 ** i)) for i in range(80)}
                        | {n}))


def _levels(n, gs):
    return _ffn_levels(n) if gs == 1 else tuple(range(n + 1))


def _problem(M, d_in, d_out, seed):
    """M seeded modules: W, and the fp32 inverse of a damped Hessian of
    256 calibration rows each."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((M, d_in, d_out)).astype(np.float32)
    Hinv = []
    for _ in range(M):
        X = rng.standard_normal((256, d_in)).astype(np.float32)
        H = np.asarray(ref_obs.build_hessian(jnp.asarray(X.T @ X)))
        Hinv.append(np.linalg.inv(H.astype(np.float64)).astype(np.float32))
    return W, np.stack(Hinv)


def _assert_close(got, want):
    np.testing.assert_array_equal(np.asarray(got.order),
                                  np.asarray(want.order))
    np.testing.assert_allclose(np.asarray(got.errors),
                               np.asarray(want.errors), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.snapshots, np.float32),
                               np.asarray(want.snapshots, np.float32),
                               atol=2e-3, rtol=2e-3)


def _np(res):
    return type(res)(*(None if t is None else t.float().numpy()
                       if t.is_floating_point() else t.numpy()
                       for t in res))


@pytest.mark.parametrize("n,gs,kw", [
    (96, 1, SMALL), (24, 4, SMALL), (384, 1, {}), (6, 16, {}),
    (14336, 1, {}), (8, 512, {}), (3072, 1, {}), (12, 64, {}),
    (64, 1, dict(min_rows=8, pad_rows=8, ratio=0.9)), (50, 3, {}),
    (40, 1, dict(pad_rows=1)),
])
def test_compaction_schedule_matches_reference(n, gs, kw):
    levels = _levels(n, gs)
    got = obs._compaction_schedule(n, gs, max(levels), levels, **kw)
    assert got == ref_obs._compaction_schedule(n, gs, max(levels), levels,
                                               **kw)
    assert got[0][0] == 0 and got[-1][1] == max(levels)
    for (s0, e0, w0, _), (s1, _, w1, l1) in zip(got, got[1:]):
        assert e0 == s1 and w1 < w0 and l1 <= w1 and s1 in levels
    for s0, _, _, l0 in got:
        assert l0 == n - s0
    np.testing.assert_array_equal(
        obs._slot_schedule(max(levels), levels),
        np.asarray(ref_obs._slot_schedule(max(levels), levels)))


@pytest.mark.parametrize("gs,d_in,d_out", [(1, 96, 40), (4, 96, 32)])
def test_compact_matches_plain_and_reference(gs, d_in, d_out):
    """One module: the compacted core equals the port's plain core and
    the reference's compacted core (orders, perm, errors, snapshots)."""
    W, Hinv = _problem(1, d_in, d_out, seed=gs)
    n = d_in // gs
    levels = _levels(n, gs)
    kw = dict(group_size=gs, n_remove=max(levels), levels=levels)
    assert len(obs._compaction_schedule(n, gs, max(levels), levels,
                                        **SMALL)) > 1
    got = obs.prune_structured_compact(torch.from_numpy(W[0]),
                                       torch.from_numpy(Hinv[0]), **kw,
                                       **SMALL)
    plain = obs.prune_structured(torch.from_numpy(W[0]),
                                 torch.from_numpy(Hinv[0]), **kw)
    assert plain.perm is None
    _assert_close(_np(got), _np(plain))
    want = ref_obs.prune_structured_compact(jnp.asarray(W[0]),
                                            jnp.asarray(Hinv[0]), **kw,
                                            **SMALL)
    _assert_close(_np(got), want)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))


@pytest.mark.parametrize("gs,d_in,d_out", [(1, 96, 40), (4, 96, 32)])
def test_batched_compact_matches_plain_and_reference(gs, d_in, d_out):
    """A stack of three modules compacts in lockstep on one schedule,
    each with its own removal order and perm."""
    W, Hinv = _problem(3, d_in, d_out, seed=10 + gs)
    n = d_in // gs
    levels = _levels(n, gs)
    kw = dict(group_size=gs, n_remove=max(levels), levels=levels)
    got = obs.prune_structured_batched_compact(
        torch.from_numpy(W), torch.from_numpy(Hinv), **kw, **SMALL)
    _assert_close(_np(got), _np(obs.prune_structured_batched(
        torch.from_numpy(W), torch.from_numpy(Hinv), **kw)))
    want = ref_obs.prune_structured_batched_compact(
        jnp.asarray(W), jnp.asarray(Hinv), **kw, **SMALL)
    _assert_close(_np(got), want)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    assert len({tuple(o) for o in got.order.tolist()}) == 3
    for m in range(3):  # each module's core alone gives its lane
        one = obs.prune_structured_compact(torch.from_numpy(W[m]),
                                           torch.from_numpy(Hinv[m]), **kw,
                                           **SMALL)
        for a, b in zip(one, got):
            assert torch.equal(a, b[m])


def test_compact_partial_run_keeps_live_perm():
    """Stopped before every structure is removed: the perm holds every
    live structure, and the last snapshot's nonzero rows are live ones
    (the reference's test_compact_partial_run_keeps_live_perm)."""
    W, Hinv = _problem(1, 64, 16, seed=7)
    kw = dict(group_size=1, n_remove=32, levels=(0, 8, 16, 24, 32),
              min_rows=8, pad_rows=8, ratio=0.9)
    res = obs.prune_structured_compact(torch.from_numpy(W[0]),
                                       torch.from_numpy(Hinv[0]), **kw)
    gone = set(res.order.tolist())
    assert len(gone) == 32
    live = [g for g in range(64) if g not in gone]
    assert set(live) <= set(res.perm.tolist())
    snap = res.snapshots[-1].float().numpy()
    assert set(np.flatnonzero(np.abs(snap).sum(1)).tolist()) <= set(live)
    want = ref_obs.prune_structured_compact(jnp.asarray(W[0]),
                                            jnp.asarray(Hinv[0]), **kw)
    np.testing.assert_array_equal(res.perm.numpy(), np.asarray(want.perm))
    _assert_close(_np(res), want)


def test_compact_core_launches_the_downdate_on_the_live_prefix(monkeypatch):
    """Every step of a later segment hands ``obs_downdate`` the live
    prefix (``d_live`` below the working rows) where the segment's
    working set has a dead padded tail; the first segment runs whole."""
    W, Hinv = _problem(2, 96, 8, seed=3)
    levels = _levels(96, 1)
    segs = obs._compaction_schedule(96, 1, max(levels), levels, **SMALL)
    seen = []
    real = obs.obs_downdate

    def spy(W, Hinv, *args, d_live=None):
        seen.append((W.shape[1], d_live))
        return real(W, Hinv, *args, d_live=d_live)

    monkeypatch.setattr(obs, "obs_downdate", spy)
    obs.prune_structured_batched_compact(
        torch.from_numpy(W), torch.from_numpy(Hinv), group_size=1,
        n_remove=max(levels), levels=levels, **SMALL)
    want = [(w, l if l < w else None)
            for s, e, w, l in segs for _ in range(s, e)]
    assert seen == want
    assert any(d is not None and d < w for w, d in seen)


@pytest.fixture(scope="module")
def ref():
    """Reference weights and Hessians (the quickstart's gpt2-tiny), and
    the reference's plain database of them."""
    params = ref_model_init(REF_TINY, jax.random.key(0))[0]
    calib = ref_calibration_batches(REF_TINY, 24, 64, batch=8)
    hess = ref_collect_hessians(REF_TINY, params, calib)
    return {"params": params, "hess": hess,
            "db": ref_database.build_database(REF_TINY, params, hess)}


@pytest.mark.parametrize("batched", [True, False])
def test_compact_database_keeps_the_reference_orders(ref, batched):
    """``build_database(compact=True)`` fed the reference's Hessians, on
    both routes: the reference's removal orders, and the port's plain
    database's errors and snapshots. Both kinds compact at the default
    schedule (FFN 384 rows, attention 6 heads of 16)."""
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params"]),
                               device="cpu")
    hess = {k: torch.from_numpy(np.array(v)) for k, v in
            ref["hess"].items()}
    for mod in registry(CFG):
        lv = level_grid(mod)
        assert len(obs._compaction_schedule(
            mod.n_structures, mod.group_size, max(lv), lv)) > 1, mod.name
    got = database.build_database(CFG, params, hess, batched=batched,
                                  compact=True, device="cpu")
    plain = database.build_database(CFG, params, hess, batched=batched,
                                    device="cpu")
    assert list(got) == list(ref["db"])
    for name, want in ref["db"].items():
        np.testing.assert_array_equal(got[name].order, want.order,
                                      err_msg=name)
        np.testing.assert_array_equal(got[name].levels, want.levels)
        np.testing.assert_allclose(got[name].errors, plain[name].errors,
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            got[name].snapshots.astype(np.float32),
            plain[name].snapshots.astype(np.float32), atol=2e-3, rtol=2e-3,
            err_msg=name)
        np.testing.assert_allclose(
            got[name].snapshots.astype(np.float32),
            want.snapshots.astype(np.float32), atol=2e-3, rtol=2e-3,
            err_msg=name)
