"""The port's Mamba-2 (SSD) slice against the JAX package, on the
reference's smoke Mamba-2 (``smoke_config("mamba2-2.7b")``: 2 layers,
d_model 128, 8 SSD heads x 32, state 16, chunk 32, vocab 512) in fp32,
with the reference's weights carried over by the weight bridge and
inputs made with numpy from a seed:

* the chunked SSD scan (its intra-chunk pass on the plain path) against
  the reference's recurrence oracle ``ref.ssd_ref``, its model twin
  ``models.ssm.ssd_chunked`` and its Pallas kernel in interpret mode, on
  the reference's ``SSD_CASES`` and with a threaded initial state, at the
  reference's 2e-3; one bf16 case against the model twin;
* ``ssm_apply`` with its capture and its decode cache, the model's
  forward logits, a decode step and greedy ``generate`` tokens;
* the ``ssm`` unit: registry, level grids and the ``ssm_time`` cost
  table; the Hessians of its layer-level capture; the database from the
  reference's Hessians (identical removal orders, snapshots within fp16
  tolerance); shrunk leaves bit-equal to the reference's ``shrink`` and
  ``forward_pruned`` within 2e-2 of the masked model (the reference's
  bound in tests/test_prune_units.py); the family search from the
  reference's database and table; ``oneshot_prune`` end to end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.core import database as ref_database
from repro.core import spdy as ref_spdy
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.latency import build_table as ref_build_table
from repro.core.shrink import shrink as ref_shrink
from repro.core.structures import level_grid as ref_level_grid
from repro.core.structures import registry as ref_registry
from repro.data import calibration_batches as ref_calibration_batches
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.ssd_scan import ssd_intra_chunk_kernel as ref_intra_chunk
from repro.models import generate as ref_generate
from repro.models import model_init as ref_model_init
from repro.models import ssm as ref_ssm
from repro.models.pruned import forward_pruned as ref_forward_pruned
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_cache as ref_init_cache
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro_torch.configs import MAMBA2_2P7B, ModelConfig
from repro_torch.core import database, hessian, spdy
from repro_torch.core.latency import LatencyTable, build_table
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.core.shrink import shrink, shrink_from_stitched
from repro_torch.core.structures import (PrunableModule, drop_layer,
                                         level_grid, registry)
from repro_torch.data import calibration_batches
from repro_torch.kernels import (reset_launch_counts, ssd_intra_chunk,
                                 ssd_intra_chunk_plain)
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models import (decode_step, forward, generate, init_cache,
                                ssm as ssm_mod)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import apply_norm, embed_tokens, unembed
from repro_torch.models.pruned import (forward_pruned, init_cache_pruned,
                                       prefill_pruned)
from repro_torch.models.transformer import check_supported
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.serve import DenseServeModel


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REF_SSM = smoke_config("mamba2-2.7b").replace(dtype="float32")
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=8, seq=64, mode="prefill")
TARGETS = [1.4, 2.0, 3.0]
TOL = 2e-3  # the reference's SSD tolerance (tests/test_kernels.py)

# b, s, h, p, n, chunk, head_block: the reference's tests/test_kernels.py
# SSD_CASES (s = 50 with chunk 16 is the ragged, padded case)
SSD_CASES = [
    (2, 64, 4, 32, 16, 32, 2),
    (1, 96, 8, 16, 8, 32, 4),
    (2, 50, 2, 64, 32, 16, 1),
    (1, 128, 6, 32, 16, 64, 3),
]


def port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


CFG = port_cfg(REF_SSM)


def _ssd_inputs(b, s, h, p, n, seed):
    """x, dt (softplus'ed), A, B, C as numpy fp32, drawn from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, s, n)) * 0.5
    C = rng.standard_normal((b, s, n)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _t(arrays, dtype=None):
    return [torch.from_numpy(a).to(dtype) if dtype else torch.from_numpy(a)
            for a in arrays]


# ----------------------------------------------------------------------
# the SSD scan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_chunked_matches_oracle_twin_and_pallas_kernel(case):
    b, s, h, p, n, chunk, hb = case
    arrs = _ssd_inputs(b, s, h, p, n, seed=sum(case))
    y, st = ssd_chunked(*_t(arrs), chunk)
    want = {
        "ssd_ref": ref_kernels.ssd_ref(*arrs),
        "model twin": ref_ssm.ssd_chunked(*arrs, chunk=chunk),
        "Pallas kernel": ref_ops.ssd_chunked_kernel(
            *arrs, chunk=chunk, head_block=hb, interpret=True),
    }
    for name, (y_w, st_w) in want.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(y_w), atol=TOL,
                                   rtol=TOL, err_msg=name)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_w), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_ssd_initial_state_threading():
    """A split run from the first part's final state equals the whole run
    (the reference's test_ssd_initial_state_threading), and the oracle
    started from the same state agrees."""
    x, dt, A, B, C = _t(_ssd_inputs(1, 40, 2, 16, 8, seed=9))
    y_full, st_full = ssd_chunked(x, dt, A, B, C, 8)
    y1, st1 = ssd_chunked(x[:, :24], dt[:, :24], A, B[:, :24], C[:, :24], 8)
    y2, st2 = ssd_chunked(x[:, 24:], dt[:, 24:], A, B[:, 24:], C[:, 24:], 8,
                          initial_state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=2e-4,
                               rtol=2e-4)
    torch.testing.assert_close(st2, st_full, atol=2e-4, rtol=2e-4)
    args = [a.numpy() for a in (x[:, 24:], dt[:, 24:], A, B[:, 24:],
                                C[:, 24:])]
    for name, (y_w, st_w) in {
            "ssd_ref": ref_kernels.ssd_ref(*args, initial_state=st1.numpy()),
            "model twin": ref_ssm.ssd_chunked(*args, chunk=8,
                                              initial_state=st1.numpy()),
    }.items():
        np.testing.assert_allclose(y2.numpy(), np.asarray(y_w), atol=TOL,
                                   rtol=TOL, err_msg=name)
        np.testing.assert_allclose(st2.numpy(), np.asarray(st_w), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("q,h,p,n", [(32, 4, 32, 16), (16, 3, 64, 32)])
def test_intra_chunk_plain_matches_pallas_body(q, h, p, n):
    """The plain intra-chunk pass against the Pallas kernel in interpret
    mode on the same chunked inputs (fp32: the same function)."""
    rng = np.random.default_rng(q + h)
    xdt = (rng.standard_normal((2, 3, q, h, p)) * 0.5).astype(np.float32)
    dA = -np.abs(rng.standard_normal((2, 3, q, h))) * 0.3
    dacs = np.cumsum(dA, axis=2).astype(np.float32)
    B, C = ((rng.standard_normal((2, 3, q, n)) * 0.5).astype(np.float32)
            for _ in range(2))
    y, st = ssd_intra_chunk(*_t([xdt, dacs, B, C]))
    y_w, st_w = ref_intra_chunk(xdt, dacs, B, C, head_block=h,
                                interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_w), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_w), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(
        ssd_intra_chunk_plain(*_t([xdt, dacs, B, C]))[0], y)


def test_ssd_chunked_bf16_follows_the_model_twin():
    """bf16 inputs: the port rounds as the reference's model twin does
    (xdt and the scores as bf16 products); 2e-2, the reference's bf16
    kernel tolerance."""
    arrs = _ssd_inputs(2, 64, 4, 32, 16, seed=5)
    x, dt, A, B, C = _t(arrs)
    y, st = ssd_chunked(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), 32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    bf = jnp.bfloat16
    y_w, st_w = ref_ssm.ssd_chunked(jnp.asarray(arrs[0], bf), arrs[1], arrs[2],
                                    jnp.asarray(arrs[3], bf),
                                    jnp.asarray(arrs[4], bf), chunk=32)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_w, np.float32), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_w), atol=2e-2,
                               rtol=2e-2)


def test_intra_chunk_on_the_cpu_counts_no_launch():
    reset_launch_counts()
    x, dt, A, B, C = _t(_ssd_inputs(1, 32, 2, 16, 8, seed=1))
    ssd_chunked(x, dt, A, B, C, 16)
    assert ssd_intra_chunk.launches == 0


# ----------------------------------------------------------------------
# the layer and the model
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """Reference weights, calibration batches, Hessians and database."""
    params = ref_model_init(REF_SSM, jax.random.key(0))[0]
    calib = ref_calibration_batches(REF_SSM, 8, 48, batch=8)
    hess = ref_collect_hessians(REF_SSM, params, calib)
    db = ref_database.build_database(REF_SSM, params, hess)
    return {"params": params, "calib": calib, "hess": hess, "db": db}


@pytest.fixture(scope="module")
def params(ref):
    return params_from_numpy(jax.tree.map(np.asarray, ref["params"]),
                             device="cpu")


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s))


def test_ssm_init_has_the_reference_leaves_and_shapes(ref):
    got = ssm_mod.ssm_init(CFG, torch.Generator().manual_seed(0), 2)
    want = ref["params"]["layers"]["ssm"]
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())


@pytest.mark.parametrize("s", [48, 2])
def test_ssm_apply_capture_and_cache_match_reference(ref, params, s):
    """Output, the ``ssm_out_in`` capture and the decode cache of one
    layer; the port's conv tails reuse the forward's projections where
    the reference projects a second time, and the caches are equal (s = 2
    is shorter than the conv window, so the tails are padded)."""
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((2, s, CFG.d_model)) * 0.5).astype(np.float32)
    lp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    rlp = jax.tree.map(lambda a: a[0], ref["params"]["layers"]["ssm"])
    caps, rcaps = {}, {}
    out, cache = ssm_mod.ssm_apply(CFG, lp, torch.from_numpy(x),
                                   capture=caps, return_cache=True)
    rout, rcache = ref_ssm.ssm_apply(REF_SSM, rlp, jnp.asarray(x),
                                     capture=rcaps, return_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(caps["ssm_out_in"].numpy(),
                               np.asarray(rcaps["ssm_out_in"]), atol=1e-5,
                               rtol=1e-5)
    assert set(cache) == set(rcache)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_forward_logits_and_captures_match_reference(ref, params):
    tokens = _tokens(2, 70, 0)
    want = ref_forward(REF_SSM, ref["params"], tokens, capture=True)
    got = forward(CFG, params, torch.from_numpy(tokens), capture=True)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["captures"]["ssm_out_in"].numpy(),
                               np.asarray(want["captures"]["ssm_out_in"]),
                               atol=1e-5, rtol=1e-5)


def test_prefill_and_decode_step_match_reference(ref, params):
    tokens = _tokens(2, 37, 1)
    want = ref_forward(REF_SSM, ref["params"], tokens, mode="prefill")
    got = forward(CFG, params, torch.from_numpy(tokens), mode="prefill")
    for k, v in want["cache_ssm"].items():
        np.testing.assert_allclose(got["cache_ssm"][k].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    rcache = ref_init_cache(REF_SSM, 2, 64)
    rcache["ssm"] = want["cache_ssm"]
    rcache["pos"] = jnp.asarray(37, jnp.int32)
    cache = init_cache(CFG, 2, 64, device="cpu")
    cache["ssm"] = got["cache_ssm"]
    cache["pos"].fill_(37)
    nxt = np.asarray([[3], [5]])
    rlog, rnew = ref_decode_step(REF_SSM, ref["params"], rcache, nxt)
    log, new = decode_step(CFG, params, cache, torch.from_numpy(nxt))
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=1e-4,
                               rtol=1e-4)
    for k, v in rnew["ssm"].items():
        np.testing.assert_allclose(new["ssm"][k].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert int(new["pos"]) == 38


def test_generate_greedy_tokens_match_reference(ref, params):
    prompt = _tokens(2, 40, 2)
    want = np.asarray(ref_generate(REF_SSM, ref["params"], prompt, 12))
    got = generate(CFG, params, torch.from_numpy(prompt), 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unsupported_families_still_raise():
    """A hybrid flag in the ssm family still raises (a hybrid block is an
    attention block with SSD heads beside it, tests/test_torch_hybrid.py);
    so do the other combinations the port does not run."""
    check_supported(CFG)
    check_supported(MAMBA2_2P7B)
    with pytest.raises(NotImplementedError, match="hybrid in the ssm family"):
        check_supported(CFG.replace(hybrid=True))
    for kw, why in (({"num_experts": 4}, "num_experts in the ssm family"),
                    ({"cross_attn_every": 5},
                     "cross_attn_every in the ssm family"),
                    ({"frontend": "vision_stub"},
                     "vision_stub without cross_attn_every"),
                    ({"family": "dense"}, "ssm_state outside"),
                    ({"ssm_state": 0}, "family='ssm' without ssm_state")):
        with pytest.raises(NotImplementedError, match=why):
            check_supported(CFG.replace(**kw))


def test_serving_engine_refuses_ssm_models(params):
    """As the reference's runtime: no serving engine for SSM caches."""
    with pytest.raises(NotImplementedError):
        DenseServeModel(CFG, params, 64)


# ----------------------------------------------------------------------
# the ssm unit through the pipeline
# ----------------------------------------------------------------------

def test_registry_grids_and_ssm_time_table_match_reference():
    mods, ref_mods = registry(CFG), ref_registry(REF_SSM)
    assert [dataclasses.asdict(m) for m in mods] == \
        [dataclasses.asdict(m) for m in ref_mods]
    assert [m.kind for m in mods] == ["ssm", "ssm"]
    for m, rm in zip(mods, ref_mods):
        assert level_grid(m) == ref_level_grid(rm) == list(range(9))
    for mode in ("prefill", "decode"):
        kw = {**ENV_KW, "mode": mode}
        want = ref_build_table(REF_SSM, RefEnv(hw=TPU_V5E, **kw))
        got = build_table(CFG, InferenceEnv(hw=HW, **kw), device="cpu")
        assert sorted(got.grids) == sorted(want.grids) == ["ssm"]
        np.testing.assert_array_equal(got.grids["ssm"], want.grids["ssm"])
        np.testing.assert_array_equal(got.times["ssm"], want.times["ssm"])
        assert got.base == want.base
    # the full-width model: 81 levels, out_proj rows in groups of 64
    m = registry(MAMBA2_2P7B)[0]
    assert (m.group_size, m.n_structures, m.d_in) == (64, 80, 5120)
    assert len(level_grid(m)) == 81


def test_measured_table_times_ssm_levels_as_ffn_modules():
    table = build_table(CFG, InferenceEnv(hw=None, **ENV_KW), "measure",
                        device="cpu", reps=1, warmup=0)
    assert list(table.grids) == ["ssm"]
    assert table.grids["ssm"][-1] == CFG.ssm_heads
    assert table.times["ssm"][-1] == 0.0 and (table.times["ssm"][:-1] > 0).all()


def test_hessians_of_the_layer_level_capture_match_reference(ref, params):
    calib = calibration_batches(CFG, 8, 48, batch=8)
    got = hessian.collect_hessians(CFG, params, calib, device="cpu")
    assert list(got) == list(ref["hess"]) == ["L0.ssm", "L1.ssm"]
    for name, want in ref["hess"].items():
        want = np.asarray(want)
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def port_db(ref, params):
    hess = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["hess"].items()}
    return database.build_database(CFG, params, hess, device="cpu")


def test_database_from_reference_hessians_matches_reference(ref, port_db):
    assert list(port_db) == list(ref["db"])
    for name, w in ref["db"].items():
        g = port_db[name]
        np.testing.assert_array_equal(g.levels, w.levels)
        np.testing.assert_array_equal(g.order, w.order, err_msg=name)
        np.testing.assert_allclose(g.errors, w.errors, rtol=1e-3, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g.snapshots.astype(np.float32),
                                   w.snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=name)


def _assignment(kind):
    if kind == "mixed":
        return {"L0.ssm": 3, "L1.ssm": 5}
    if kind == "module_drop":
        return {"L0.ssm": 8, "L1.ssm": 2}
    return drop_layer({"L0.ssm": 1, "L1.ssm": 0}, registry(CFG), 1)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, t) for k in sorted(tree)
                for p, t in _leaves(tree[k])]
    return [("", tree)]


@pytest.mark.parametrize("kind", ["mixed", "module_drop", "layer_drop"])
def test_shrink_matches_reference_and_the_masked_model(ref, params, port_db,
                                                       kind):
    a = _assignment(kind)
    want = ref_shrink(REF_SSM, ref["params"], ref["db"], a)
    got = shrink(CFG, params, port_db, a, device="cpu")
    assert got.num_params() == want.num_params()
    for lg, lw in zip(got.layers, want.layers):
        assert lg.ssm_heads == lw.ssm_heads
        g, w = _leaves(lg.params), _leaves(jax.tree.map(np.asarray,
                                                       lw.params))
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, tg), (_, tw) in zip(g, w):
            if path.startswith("ssm/out_proj"):  # the port's own snapshots
                np.testing.assert_allclose(tg.numpy(), tw, atol=2e-3,
                                           rtol=2e-3, err_msg=path)
            else:
                np.testing.assert_array_equal(tg.numpy(), tw, err_msg=path)
    # shrunk from the reference's own database: every leaf bit-equal
    same_db = {n: database.ModuleDB(
        mod=PrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for n, m in ref["db"].items()}
    exact = shrink(CFG, params, same_db, a, device="cpu")
    for lg, lw in zip(exact.layers, want.layers):
        for (path, tg), (_, tw) in zip(
                _leaves(lg.params), _leaves(jax.tree.map(np.asarray,
                                                         lw.params))):
            np.testing.assert_array_equal(tg.numpy(), tw, err_msg=path)
    # the shrunk model gives the masked model's outputs
    tokens = torch.from_numpy(np.asarray(ref["calib"][0]["tokens"]))
    masked = database.apply_assignment(CFG, params, port_db, a)
    out = forward_pruned(got, tokens)
    assert torch.isfinite(out).all()
    assert float((out - forward(CFG, masked, tokens)["logits"]).abs().max()) \
        < 2e-2
    if kind == "mixed":  # and the reference's pruned forward's
        np.testing.assert_allclose(
            forward_pruned(exact, tokens).numpy(),
            np.asarray(ref_forward_pruned(want, ref["calib"][0]["tokens"])),
            atol=1e-4, rtol=1e-4)
    stitched = database.SnapshotCache(CFG, port_db, device="cpu").apply(
        params, a)
    dev = shrink_from_stitched(CFG, stitched, port_db, a)
    for ld, lg in zip(dev.layers, got.layers):
        assert ld.ssm_heads == lg.ssm_heads
        for (path, t1), (_, t2) in zip(_leaves(ld.params), _leaves(lg.params)):
            assert torch.equal(t1, t2), path


def test_all_heads_removed_runs_as_identity(params, port_db):
    a = {"L0.ssm": 8, "L1.ssm": 8}
    pm = shrink(CFG, params, port_db, a, device="cpu")
    assert [l.ssm_heads for l in pm.layers] == [0, 0]
    tokens = torch.from_numpy(_tokens(2, 16, 3))
    x = embed_tokens(CFG, params["embed"], tokens)
    x = apply_norm(CFG, params["final_norm"], x)
    want = unembed(CFG, params["embed"], {}, x)
    torch.testing.assert_close(forward_pruned(pm, tokens), want)


def test_pruned_decode_runtime_refuses_ssm(params, port_db):
    pm = shrink(CFG, params, port_db, _assignment("mixed"), device="cpu")
    with pytest.raises(NotImplementedError):
        init_cache_pruned(pm, 1, 16)
    with pytest.raises(NotImplementedError):
        prefill_pruned(pm, torch.zeros((1, 4), dtype=torch.long), 16)


def test_search_family_matches_reference(ref):
    ref_tab = ref_build_table(REF_SSM, RefEnv(hw=TPU_V5E, **ENV_KW))
    want = ref_spdy.search_family(ref["db"], ref_tab, TARGETS, steps=48,
                                  pop=16, seed=3)
    port_db = {n: database.ModuleDB(
        mod=PrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for n, m in ref["db"].items()}
    tab = LatencyTable(env=InferenceEnv(hw=HW, **ENV_KW),
                       grids=dict(ref_tab.grids), times=dict(ref_tab.times),
                       base=ref_tab.base)
    got = spdy.search_family(port_db, tab, TARGETS, steps=48, pop=16, seed=3)
    for t in TARGETS:
        assert got[t].assignment == want[t].assignment
        assert got[t].score == want[t].score
        assert got[t].speedup >= t


def test_oneshot_prune_end_to_end(params):
    """The slice on the CPU, as the reference's
    test_oneshot_e2e_new_unit_kinds[ssm] runs it: every member meets its
    target and its shrunk model gives its stitched model's outputs."""
    calib = calibration_batches(CFG, 4, 32, batch=4)
    res = oneshot_prune(CFG, params, calib, InferenceEnv(hw=HW, **ENV_KW),
                        TARGETS, search_steps=20, search_pop=8, seed=0,
                        device="cpu")
    assert set(res.db) == {"L0.ssm", "L1.ssm"}
    tokens = calib[0]["tokens"]
    for t in TARGETS:
        v = res.variants[t]
        assert v.speedup >= t and np.isfinite(v.calib_loss)
        pm = shrink(CFG, v.params, res.db, v.assignment, device="cpu")
        err = (forward_pruned(pm, tokens)
               - forward(CFG, v.params, tokens)["logits"]).abs().max()
        assert float(err) < 2e-2
