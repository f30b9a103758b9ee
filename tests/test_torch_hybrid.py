"""The port's hybrid block (Hymba: attention and SSD heads side by side on
one normed input, averaged, then the FFN) against the JAX package, on the
reference's smoke Hymba (``smoke_config("hymba-1.5b")``: 2 layers,
d_model 128, 4 query heads x 32 on 1 KV head with a 64-token window, 4
SSD heads x 32, state 16, chunk 32, d_ff 256, vocab 512) in fp32, with
the reference's weights carried over by the weight bridge and inputs made
with numpy from a seed:

* the config and the weight bridge: the registry entry, leaf for leaf
  params and a whole ``TrainState``;
* the forward's logits, captures (key sets first) and loss at the
  Mamba-2 parity tolerances of tests/test_torch_ssm.py; prefill plus
  decode steps equal to the forward (the reference's
  tests/test_models_smoke.py case, and past the window); greedy
  ``generate`` tokens; three train steps from a JAX ``TrainState``;
* the mixed registry (attn, ssm, ffn in the reference's order): Hessians,
  the database fed the reference's Hessians (identical removal orders,
  snapshots within fp16), serial equal to batched on well-conditioned
  Hessians (tests/test_prune_units.py), the cost-model table number for
  number (tests/test_latency_units.py) and the measured table's kinds;
* shrink against the reference's ``shrink`` and ``forward_pruned`` with
  both branches live, attention dropped, SSD dropped and a whole layer
  dropped (tests/test_shrink.py); the pruned decode runtime still
  refuses hybrid; ``oneshot_prune`` assignments identical to the
  reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import database as ref_database
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.latency import build_table as ref_build_table
from repro.core.oneshot import oneshot_prune as ref_oneshot_prune
from repro.core.shrink import shrink as ref_shrink
from repro.core.structures import registry as ref_registry
from repro.data import calibration_batches as ref_calibration_batches
from repro.data.synthetic import make_batch_np as ref_make_batch
from repro.models import generate as ref_generate
from repro.models import loss_fn as ref_loss_fn
from repro.models import model_init as ref_model_init
from repro.models.pruned import forward_pruned as ref_forward_pruned
from repro.models.transformer import forward as ref_forward
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro.train.train_step import make_train_state as ref_make_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.configs import ModelConfig, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import database, hessian
from repro_torch.core.latency import build_table
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.core.shrink import shrink, shrink_from_stitched
from repro_torch.core.structures import (PrunableModule, drop_layer,
                                         level_grid, registry)
from repro_torch.data import calibration_batches, make_batch_np
from repro_torch.models import (forward, generate, loss_fn, model_init,
                                serve_prefill, serve_step)
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.pruned import (forward_pruned, init_cache_pruned,
                                       prefill_pruned)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.serve import DenseServeModel
from repro_torch.train import make_train_state, make_train_step

REF_HY = ref_smoke_config("hymba-1.5b").replace(dtype="float32")
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=8, seq=64, mode="prefill")
TARGETS = [1.3, 1.6, 2.0]
KINDS = ["attn", "ssm", "ffn"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


CFG = port_cfg(REF_HY)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s))


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _assert_tree_close(got, want, atol, rtol):
    g, w = _paths(got), _paths(_np(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, tg), (_, tw) in zip(g, w):
        np.testing.assert_allclose(tg.detach().numpy(), tw, atol=atol,
                                   rtol=rtol, err_msg=path)


@pytest.fixture(scope="module")
def ref():
    """Reference weights, calibration batches, Hessians and database."""
    params = ref_model_init(REF_HY, jax.random.key(0))[0]
    calib = ref_calibration_batches(REF_HY, 8, 48, batch=8)
    hess = ref_collect_hessians(REF_HY, params, calib)
    db = ref_database.build_database(REF_HY, params, hess)
    return {"params": params, "calib": calib, "hess": hess, "db": db}


@pytest.fixture(scope="module")
def params(ref):
    return params_from_numpy(_np(ref["params"]), device="cpu")


def _as_port_db(ref_db):
    """The reference's database as the port's ModuleDBs (same arrays)."""
    return {n: database.ModuleDB(
        mod=PrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for n, m in ref_db.items()}


# ----------------------------------------------------------------------
# the config and the weight bridge
# ----------------------------------------------------------------------

def test_hymba_is_ported_and_its_smoke_config_is_the_references():
    assert configs.NOT_PORTED == ()
    full = configs.get_config("hymba-1.5b")
    assert full == port_cfg(ref_get_config("hymba-1.5b"))
    assert (full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.ssm_heads, full.ssm_head_dim, full.ssm_state,
            full.ssm_chunk, full.d_ff, full.window_size) == \
        (1600, 25, 5, 64, 25, 64, 16, 256, 5504, 1024)
    assert smoke_config("hymba-1.5b") == port_cfg(
        ref_smoke_config("hymba-1.5b"))
    assert full.num_params() == ref_get_config("hymba-1.5b").num_params()


def test_model_init_has_the_reference_leaves_and_the_bridge_carries_them(
        ref, params):
    got = model_init(CFG, device="cpu")
    shapes = {p: tuple(t.shape) for p, t in _paths(got)}
    assert shapes == {p: tuple(t.shape) for p, t in _paths(_np(ref["params"]))}
    assert set(got["layers"]) == {"ln1", "attn", "ln2", "ffn", "ssm"}
    bridged = dict(_paths(params))
    for path, w in _paths(_np(ref["params"])):
        node = bridged[path]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), w, err_msg=path)


def test_train_state_bridge_carries_a_hybrid_state_leaf_for_leaf(ref):
    tcfg = RefTrainConfig(total_steps=4)
    ref_state = ref_make_train_state(REF_HY, ref["params"], tcfg)
    state = train_state_from_numpy(_np(ref_state), device="cpu")
    for got, want in ((state.params, ref_state.params),
                      (state.opt["m"], ref_state.opt["m"]),
                      (state.opt["v"], ref_state.opt["v"])):
        _assert_tree_close(got, want, atol=0, rtol=0)
    assert int(state.step) == 0 and int(state.opt["count"]) == 0


# ----------------------------------------------------------------------
# forward, decode, generate, train
# ----------------------------------------------------------------------

def test_forward_logits_captures_and_loss_match_reference(ref, params):
    tokens = _tokens(2, 70, 0)
    want = ref_forward(REF_HY, ref["params"], tokens, capture=True)
    got = forward(CFG, params, torch.from_numpy(tokens), capture=True)
    # the SSD heads' capture sits beside the attention's and the FFN's
    caps, rcaps = got["captures"], _np(want["captures"])
    assert set(caps) == set(rcaps) == {"attn", "ffn", "ssm_out_in"}
    assert [p for p, _ in _paths(caps)] == [p for p, _ in _paths(rcaps)]
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    _assert_tree_close(caps, rcaps, atol=1e-5, rtol=1e-5)
    batch = make_batch_np(CFG, 2, 64, seed=3)
    np.testing.assert_allclose(
        float(loss_fn(CFG, params, batch)["loss"]),
        float(ref_loss_fn(REF_HY, ref["params"],
                          ref_make_batch(REF_HY, 2, 64, seed=3))["loss"]),
        rtol=1e-5)


@pytest.mark.parametrize("s,steps", [(64, 4), (90, 8)])
def test_prefill_and_decode_equal_the_forward(ref, params, s, steps):
    """The reference's tests/test_models_smoke.py decode case (64 tokens,
    4 decoded), and one past the 64-token window, where the K/V ring
    wraps: each decoded position's logits equal the full forward's, and
    the prefill's caches equal the reference's."""
    tokens = torch.from_numpy(_tokens(2, s, s))
    full = forward(CFG, params, tokens)["logits"]
    n = s - steps
    logits, cache = serve_prefill(CFG, params, {"tokens": tokens[:, :n]})
    assert set(cache) == {"pos", "attn", "ssm"}
    want = ref_forward(REF_HY, ref["params"], tokens[:, :n].numpy(),
                       mode="prefill")
    got = forward(CFG, params, tokens[:, :n], mode="prefill")
    assert set(got) >= {"cache", "cache_ssm"}
    _assert_tree_close(got["cache_ssm"], want["cache_ssm"], atol=1e-5,
                       rtol=1e-5)
    _assert_tree_close(got["cache"], want["cache"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, n - 1].numpy(), atol=2e-4, rtol=2e-4)
    for t in range(n, s):
        logits, cache = serve_step(CFG, params, cache, tokens[:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-4, rtol=2e-4, err_msg=str(t))
    assert int(cache["pos"]) == s


def test_generate_greedy_tokens_match_reference(ref, params):
    prompt = _tokens(2, 40, 2)
    want = np.asarray(ref_generate(REF_HY, ref["params"], prompt, 12))
    got = generate(CFG, params, torch.from_numpy(prompt), 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_steps_match_reference_from_a_jax_state(ref):
    """Three distillation steps (a teacher of another seed, 2
    microbatches, 48 tokens: a chunk of 32 and a padded one) from the
    same JAX TrainState on both sides: metrics 1e-4 relative, params
    1e-5 (the Mamba-2 slice's tolerances)."""
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=3,
              microbatches=2, distill_logit=1.0, distill_token=0.5)
    teacher = ref_model_init(REF_HY, jax.random.key(1))[0]
    ref_step = jax.jit(ref_make_train_step(REF_HY, RefTrainConfig(**kw),
                                           teacher_params=teacher))
    ref_state = ref_make_train_state(REF_HY, ref["params"],
                                     RefTrainConfig(**kw))
    state = train_state_from_numpy(_np(ref_state), device="cpu")
    step = make_train_step(CFG, TrainConfig(**kw), teacher_params=(
        params_from_numpy(_np(teacher), device="cpu")), device="cpu")
    for i in range(3):
        ref_state, want = ref_step(ref_state, ref_make_batch(
            REF_HY, 8, 48, seed=11, step=i))
        state, got = step(state, make_batch_np(CFG, 8, 48, seed=11, step=i))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert int(state.step) == int(ref_state.step) == 3
    _assert_tree_close(state.params, ref_state.params, atol=1e-5, rtol=0)


def test_smoke_train_step_with_microbatches():
    """The reference's tests/test_models_smoke.py train case on the port:
    one step of the smoke config at 2 x 64 tokens, 2 microbatches."""
    cfg = smoke_config("hymba-1.5b")
    params = model_init(cfg, device="cpu")
    tcfg = TrainConfig(microbatches=2, total_steps=10)
    state, metrics = make_train_step(cfg, tcfg, device="cpu")(
        make_train_state(cfg, params, tcfg), make_batch_np(cfg, 2, 64,
                                                           seed=1))
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 1
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state.params))


# ----------------------------------------------------------------------
# the mixed registry through the pipeline
# ----------------------------------------------------------------------

def test_registry_holds_attn_ssm_and_ffn_in_the_references_order():
    mods, ref_mods = registry(CFG), ref_registry(REF_HY)
    assert [dataclasses.asdict(m) for m in mods] == \
        [dataclasses.asdict(m) for m in ref_mods]
    assert [m.kind for m in mods] == KINDS * 2
    assert [len(level_grid(m)) for m in mods[:3]] == [2, 5, 39]
    full = registry(configs.get_config("hymba-1.5b"))[:3]
    assert [(m.kind, m.group_size, m.n_structures) for m in full] == \
        [("attn", 320, 5), ("ssm", 64, 25), ("ffn", 1, 5504)]


def test_hessians_match_reference(ref, params):
    calib = calibration_batches(CFG, 8, 48, batch=8)
    got = hessian.collect_hessians(CFG, params, calib, device="cpu")
    # the port keeps registry order; the reference's dict went through jit
    assert list(got) == [f"L{l}.{k}" for l in range(2) for k in KINDS]
    assert set(got) == set(ref["hess"])
    for name, want in ref["hess"].items():
        want = np.asarray(want)
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def port_db(ref, params):
    hess = {k: torch.from_numpy(np.array(v)) for k, v in ref["hess"].items()}
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


def test_mixed_kind_database_serial_equals_batched(ref, params):
    """tests/test_prune_units.py's hybrid-attn-ssm-ffn case: on
    well-conditioned synthetic Hessians the serial and batched databases
    make identical removals (snapshots at fp16 resolution), and so does
    the reference's."""
    rng = np.random.default_rng(0)
    hess = {}
    for m in registry(CFG):
        X = rng.standard_normal((3 * m.d_in + 16, m.d_in))
        hess[m.name] = (X.T @ X / len(X)).astype(np.float32)
    th = {k: torch.from_numpy(v) for k, v in hess.items()}
    db_s = database.build_database(CFG, params, th, batched=False,
                                   device="cpu")
    db_b = database.build_database(CFG, params, th, batched=True,
                                   device="cpu")
    want = ref_database.build_database(
        REF_HY, ref["params"], {k: jnp.asarray(v) for k, v in hess.items()})
    assert list(db_s) == list(db_b) == list(want)
    for name in db_s:
        a, b, w = db_s[name], db_b[name], want[name]
        np.testing.assert_array_equal(a.levels, b.levels, err_msg=name)
        np.testing.assert_array_equal(a.order, b.order, err_msg=name)
        np.testing.assert_array_equal(a.order, w.order, err_msg=name)
        np.testing.assert_allclose(a.errors, b.errors, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(
            a.snapshots.astype(np.float32), b.snapshots.astype(np.float32),
            atol=2e-3, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_costmodel_table_matches_reference_number_for_number(mode):
    kw = {**ENV_KW, "mode": mode}
    want = ref_build_table(REF_HY, RefEnv(hw=TPU_V5E, **kw))
    got = build_table(CFG, InferenceEnv(hw=HW, **kw), device="cpu")
    assert list(got.grids) == list(want.grids) == KINDS
    for kind in KINDS:
        np.testing.assert_array_equal(got.grids[kind], want.grids[kind])
        np.testing.assert_array_equal(got.times[kind], want.times[kind])
    assert got.base == want.base
    # layer 1 dropped whole: the base and layer 0's dense modules
    mods = registry(CFG)
    a = {m.name: (m.n_structures if m.layer == 1 else 0) for m in mods}
    assert got.runtime_of(a, mods) == pytest.approx(
        got.base + sum(got.module_time(m.kind, 0) for m in mods
                       if m.layer == 0))
    assert got.runtime_of(a, mods) == pytest.approx(
        want.runtime_of(a, cfg=REF_HY))


def test_measured_table_times_every_kind():
    table = build_table(CFG, InferenceEnv(hw=None, **ENV_KW), "measure",
                        device="cpu", reps=1, warmup=0)
    assert list(table.grids) == KINDS
    for kind in KINDS:
        t = table.times[kind]
        assert t[-1] == 0.0 and (t[:-1] > 0).all(), kind
    assert table.base > 0.0


# ----------------------------------------------------------------------
# shrink, the pruned forward, one-shot
# ----------------------------------------------------------------------

def _assignment(case):
    """attn has 1 KV group (4 query heads), ssm 4 heads, ffn 256 rows."""
    if case == "both_live":
        return {"L0.attn": 0, "L0.ssm": 1, "L0.ffn": 60,
                "L1.attn": 0, "L1.ssm": 2, "L1.ffn": 100}
    if case == "attn_dropped":  # tests/test_shrink.py's hybrid case
        return {m.name: 1 if m.kind != "ffn" else 60 for m in registry(CFG)}
    if case == "ssm_dropped":
        return {"L0.attn": 0, "L0.ssm": 4, "L0.ffn": 60,
                "L1.attn": 0, "L1.ssm": 4, "L1.ffn": 0}
    return drop_layer({"L0.attn": 0, "L0.ssm": 3, "L0.ffn": 120,
                       "L1.attn": 0, "L1.ssm": 0, "L1.ffn": 0},
                      registry(CFG), 1)


@pytest.mark.parametrize("case", ["both_live", "attn_dropped", "ssm_dropped",
                                  "layer_dropped"])
def test_shrink_matches_reference_and_the_masked_model(ref, params, port_db,
                                                       case):
    a = _assignment(case)
    want = ref_shrink(REF_HY, ref["params"], ref["db"], a)
    got = shrink(CFG, params, port_db, a, device="cpu")
    assert got.num_params() == want.num_params()
    for lg, lw in zip(got.layers, want.layers):
        assert (lg.kv_groups, lg.ssm_heads, lg.d_ff) == \
            (lw.kv_groups, lw.ssm_heads, lw.d_ff)
        g, w = _paths(lg.params), _paths(_np(lw.params))
        assert [p for p, _ in g] == [p for p, _ in w]
        # the shared ln1 stays while either branch lives
        assert ("ln1" in lg.params) == (lg.kv_groups + lg.ssm_heads > 0)
    # shrunk from the reference's own database: every leaf bit-equal, and
    # the reference's pruned forward (its averaging of the live branches)
    exact = shrink(CFG, params, _as_port_db(ref["db"]), a, device="cpu")
    for lg, lw in zip(exact.layers, want.layers):
        for (path, tg), (_, tw) in zip(_paths(lg.params),
                                       _paths(_np(lw.params))):
            np.testing.assert_array_equal(tg.numpy(), tw, err_msg=path)
    tokens = np.asarray(ref["calib"][0]["tokens"])
    np.testing.assert_allclose(
        forward_pruned(exact, torch.from_numpy(tokens)).numpy(),
        np.asarray(ref_forward_pruned(want, jnp.asarray(tokens))),
        atol=1e-4, rtol=1e-4)
    # the shrunk model gives the masked model's outputs
    masked = database.apply_assignment(CFG, params, port_db, a)
    out = forward_pruned(got, torch.from_numpy(tokens))
    assert torch.isfinite(out).all()
    assert float((out - forward(CFG, masked, torch.from_numpy(tokens))[
        "logits"]).abs().max()) < 2e-2
    stitched = database.SnapshotCache(CFG, port_db, device="cpu").apply(
        params, a)
    dev = shrink_from_stitched(CFG, stitched, port_db, a)
    for ld, lg in zip(dev.layers, got.layers):
        assert (ld.kv_groups, ld.ssm_heads) == (lg.kv_groups, lg.ssm_heads)
        for (path, t1), (_, t2) in zip(_paths(ld.params), _paths(lg.params)):
            assert torch.equal(t1, t2), path


def test_pruned_decode_runtime_and_serving_refuse_hybrid(params, port_db):
    """As the reference's ``_check_decodable``: the pruned decode runtime
    covers attention + FFN/MoE decoders only, and the serving engine
    (full attention only) refuses Hymba's sliding window too."""
    pm = shrink(CFG, params, port_db, _assignment("both_live"),
                device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        init_cache_pruned(pm, 1, 16)
    with pytest.raises(NotImplementedError, match="hybrid"):
        prefill_pruned(pm, torch.zeros((1, 4), dtype=torch.long), 16)
    with pytest.raises(NotImplementedError):
        DenseServeModel(CFG, params, 64)


def test_oneshot_prune_assignments_match_reference(ref, params):
    """Both packages' ``oneshot_prune`` on the same weights and
    calibration tokens, the same cost-model table and search: identical
    assignments; every member meets its target and its shrunk model gives
    its stitched model's outputs."""
    calib = calibration_batches(CFG, 8, 48, batch=8)
    kw = dict(search_steps=24, search_pop=8, seed=0)
    want = ref_oneshot_prune(REF_HY, ref["params"], ref["calib"],
                             RefEnv(hw=TPU_V5E, **ENV_KW), TARGETS, **kw)
    res = oneshot_prune(CFG, params, calib, InferenceEnv(hw=HW, **ENV_KW),
                        TARGETS, device="cpu", **kw)
    assert list(res.db) == list(want.db)
    tokens = calib[0]["tokens"]
    for t in TARGETS:
        v, w = res.variants[t], want.variants[t]
        assert v.assignment == w.assignment, t
        assert v.speedup >= t and v.speedup == pytest.approx(w.speedup)
        np.testing.assert_allclose(v.calib_loss, w.calib_loss, rtol=1e-4)
        pm = shrink(CFG, v.params, res.db, v.assignment, device="cpu")
        err = (forward_pruned(pm, tokens)
               - forward(CFG, v.params, tokens)["logits"]).abs().max()
        assert float(err) < 2e-2
