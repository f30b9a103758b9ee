"""The port's grouped cross-attention stack (Llama-3.2-Vision: the self
layers in groups of ``cross_attn_every``, each group followed by one gated
cross-attention module over the vision stub's patch embeddings) against
the JAX package, in fp32 on two configs with the reference's weights
carried over by the weight bridge:

* ``smoke``: the reference's ``smoke_config("llama-3.2-vision-11b")`` (2
  self layers and 1 cross module, d_model 128, 4 heads on 1 KV head of
  32, d_ff 256, 16 frames of 128, vocab 512; no ``frontend_proj``, since
  128 = d_model);
* ``two_groups``: the same with ``frontend_dim=96, num_layers=4`` (two
  cross modules, and frames of 96 through ``frontend_proj``).

The cross gates start at zero (``tanh(0) = 0``: the frames then reach no
logit), so every parity check here sets them to 1.0 on both sides first.
Tolerances:

* frontend batches and calibration batches bit-equal;
* each group's cross keys/values (``frontend_kv``) 1e-5;
* logits 1e-4 abs/rel, captures and hiddens 1e-5 (a group's last hidden
  state read before its cross module), loss 1e-5 relative;
* prefill and decode against the full forward 2e-3 abs + 1e-2 rel (the
  reference's tests/test_models_smoke.py), greedy tokens equal;
* Hessians 1e-5 of their scale (tighter than 1e-3 * sqrt(N));
* the database fed the reference's Hessians: identical removal orders,
  errors 1e-3, snapshots 2e-3 (fp16);
* ``oneshot_prune`` on the cost model: identical assignments and
  speedups, calibration losses 1e-4 relative;
* the distillation loss 1e-5 relative.

``shrink``, ``shrink_from_stitched``, ``forward_pruned`` and
``gradual_prune`` refuse a grouped cross config: the pruned runtime has
no cross-attention.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.core import database as ref_database
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.oneshot import oneshot_prune as ref_oneshot_prune
from repro.core.structures import registry as ref_registry
from repro.data import calibration_batches as ref_calibration_batches
from repro.data.synthetic import make_batch_np as ref_make_batch
from repro.distill.losses import distillation_loss as ref_distillation_loss
from repro.models import generate as ref_generate
from repro.models import loss_fn as ref_loss_fn
from repro.models import model_init as ref_model_init
from repro.models.transformer import forward as ref_forward
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro_torch import configs
from repro_torch.configs import ModelConfig, smoke_config
from repro_torch.core import database, hessian
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.core.pipeline import gradual_prune
from repro_torch.core.shrink import shrink, shrink_from_stitched
from repro_torch.core.structures import registry
from repro_torch.data import calibration_batches, make_batch_np
from repro_torch.distill.losses import distillation_loss
from repro_torch.models import (forward, generate, loss_fn, model_init,
                                serve_prefill, serve_step)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.pruned import PrunedModel, forward_pruned
from repro_torch.models.transformer import (check_supported, frontend_kv,
                                            init_cache)
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.serve import DenseServeModel

ARCH = "llama-3.2-vision-11b"
REF_CFGS = {
    "smoke": ref_smoke_config(ARCH).replace(dtype="float32"),
    "two_groups": ref_smoke_config(ARCH).replace(
        dtype="float32", frontend_dim=96, num_layers=4),
}
NAMES = sorted(REF_CFGS)
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=8, seq=64, mode="prefill")
TARGETS = [1.3, 1.6, 2.0]


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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


def _set_gates(params, value):
    """The reference's params with every cross gate at ``value``."""
    xattn = params["cross"]["xattn"]
    cross = {**params["cross"], "xattn": {
        **xattn, "gate": jnp.full_like(xattn["gate"], value)}}
    return {**params, "cross": cross}


def _port_gates(params, value):
    xattn = params["cross"]["xattn"]
    cross = {**params["cross"], "xattn": {
        **xattn, "gate": torch.full_like(xattn["gate"], value)}}
    return {**params, "cross": cross}


@functools.lru_cache(maxsize=None)
def _model(name):
    """(reference cfg, port cfg, reference params with gates 1.0, the
    port's params carried over by the bridge)."""
    ref_cfg = REF_CFGS[name]
    ref_params = _set_gates(ref_model_init(ref_cfg, jax.random.key(0))[0],
                            1.0)
    return (ref_cfg, port_cfg(ref_cfg), ref_params,
            params_from_numpy(_np(ref_params), device="cpu"))


def _batch(name, b, s, seed, step=0):
    """The same batch for both packages: (reference's, port's)."""
    ref_cfg, cfg = REF_CFGS[name], port_cfg(REF_CFGS[name])
    return (ref_make_batch(ref_cfg, b, s, seed=seed, step=step),
            make_batch_np(cfg, b, s, seed=seed, step=step))


# ----------------------------------------------------------------------
# the config, the weight bridge, the batches
# ----------------------------------------------------------------------

def test_llama_vision_is_ported_and_its_smoke_config_is_the_references():
    assert configs.NOT_PORTED == ()
    full = configs.get_config(ARCH)
    assert full is configs.LLAMA32_VISION_11B
    assert full == port_cfg(ref_get_config(ARCH))
    assert (full.num_layers, full.cross_attn_every, full.d_model,
            full.num_heads, full.num_kv_heads, full.d_ff, full.vocab_size,
            full.num_frontend_tokens, full.frontend_dim, full.rope_theta,
            full.frontend) == \
        (40, 5, 4096, 32, 8, 14336, 128256, 1601, 4096, 500000.0,
         "vision_stub")
    smoke = smoke_config(ARCH)
    assert smoke == port_cfg(ref_smoke_config(ARCH))
    assert (smoke.num_layers, smoke.cross_attn_every,
            smoke.num_frontend_tokens, smoke.frontend_dim) == (2, 2, 16, 128)
    assert full.param_counts() == ref_get_config(ARCH).param_counts()


@pytest.mark.parametrize("name", NAMES)
def test_model_init_has_the_reference_leaves_and_the_bridge_carries_them(
        name):
    ref_cfg, cfg, ref_params, params = _model(name)
    got = model_init(cfg, device="cpu")
    shapes = {p: tuple(t.shape) for p, t in _paths(got)}
    assert shapes == {p: tuple(t.shape) for p, t in _paths(_np(ref_params))}
    groups = cfg.num_layers // cfg.cross_attn_every
    assert set(got["cross"]) == {"lnx", "xattn"}
    assert set(got["cross"]["xattn"]) == {"wq", "wk", "wv", "wo", "gate"}
    assert tuple(got["cross"]["lnx"]["scale"].shape) == (groups, 128)
    # the gate starts closed, as the reference's
    assert torch.equal(got["cross"]["xattn"]["gate"], torch.zeros(groups))
    proj = cfg.frontend_dim != cfg.d_model
    assert ("frontend_proj" in got) == proj == (name == "two_groups")
    if proj:
        assert tuple(got["frontend_proj"].shape) == (96, 128)
    bridged = dict(_paths(params))
    for path, w in _paths(_np(ref_params)):
        node = bridged[path]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), w, err_msg=path)
    assert torch.equal(params["cross"]["xattn"]["gate"], torch.ones(groups))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_and_calibration_batches_are_the_references_bits(dtype):
    ref_cfg = REF_CFGS["two_groups"].replace(dtype=dtype)
    cfg = port_cfg(ref_cfg)
    for step in range(3):
        want = ref_make_batch(ref_cfg, 4, 24, seed=5, step=step)
        got = make_batch_np(cfg, 4, 24, seed=5, step=step)
        assert set(got) == set(want) == {"tokens", "frontend"}
        assert got["frontend"].dtype == getattr(torch, dtype)
        assert tuple(got["frontend"].shape) == (4, 16, 96)
        np.testing.assert_array_equal(
            got["frontend"].float().numpy(),
            np.asarray(want["frontend"].astype(jnp.float32)))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    got = calibration_batches(cfg, 12, 32, batch=8)
    want = ref_calibration_batches(ref_cfg, 12, 32, batch=8)
    assert [tuple(b["frontend"].shape) for b in got] == [(8, 16, 96),
                                                         (4, 16, 96)]
    for g, w in zip(got, want):
        for k in ("tokens", "frontend"):
            np.testing.assert_array_equal(
                g[k].float().numpy(), np.asarray(w[k]).astype(np.float32))


# ----------------------------------------------------------------------
# forward, decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_frontend_kv_matches_reference(name):
    ref_cfg, cfg, ref_params, params = _model(name)
    rb, pb = _batch(name, 2, 16, 1)
    want = ref_forward(ref_cfg, ref_params, rb["tokens"],
                       frontend_embeds=rb["frontend"])["frontend_kv"]
    got = frontend_kv(cfg, params, pb["frontend"])
    groups = cfg.num_layers // cfg.cross_attn_every
    assert tuple(got["k"].shape) == (groups, 2, 16, 1, 32)
    _assert_tree_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_captures_hiddens_and_loss_match_reference(name):
    ref_cfg, cfg, ref_params, params = _model(name)
    rb, pb = _batch(name, 2, 40, 2)
    want = ref_forward(ref_cfg, ref_params, rb["tokens"],
                       frontend_embeds=rb["frontend"], capture=True,
                       collect_hiddens=True)
    got = forward(cfg, params, pb["tokens"], frontend_embeds=pb["frontend"],
                  capture=True, collect_hiddens=True)
    caps, rcaps = got["captures"], _np(want["captures"])
    assert set(caps) == set(rcaps) == {"attn", "ffn"}
    assert [p for p, _ in _paths(caps)] == [p for p, _ in _paths(rcaps)]
    assert caps["attn"]["wo_in"].shape[0] == cfg.num_layers
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    _assert_tree_close(caps, rcaps, atol=1e-5, rtol=1e-5)
    assert tuple(got["hiddens"].shape) == (cfg.num_layers, 2, 40, 128)
    np.testing.assert_allclose(got["hiddens"].numpy(),
                               np.asarray(want["hiddens"]), atol=1e-5,
                               rtol=1e-5)
    _assert_tree_close(got["frontend_kv"], want["frontend_kv"], atol=1e-5,
                       rtol=1e-5)
    rb, pb = _batch(name, 2, 32, 3)
    np.testing.assert_allclose(
        float(loss_fn(cfg, params, pb)["loss"]),
        float(ref_loss_fn(ref_cfg, ref_params, rb)["loss"]), rtol=1e-5)


def test_a_groups_last_hidden_state_is_read_before_its_cross_module():
    """Closing the gates changes nothing up to and including group 0's
    last self layer (layer 1), whose hidden state is read before the
    cross module, and changes every later one."""
    _, cfg, _, params = _model("two_groups")
    _, pb = _batch("two_groups", 2, 24, 4)
    kw = dict(frontend_embeds=pb["frontend"], collect_hiddens=True)
    opened = forward(cfg, params, pb["tokens"], **kw)["hiddens"]
    closed = forward(cfg, _port_gates(params, 0.0), pb["tokens"],
                     **kw)["hiddens"]
    assert torch.equal(opened[:2], closed[:2])
    for i in (2, 3):
        assert float((opened[i] - closed[i]).abs().max()) > 1e-3, i


@pytest.mark.parametrize("name", NAMES)
def test_logits_change_with_the_frames_once_the_gate_opens(name):
    """With the gates open another set of frames moves the logits; with
    them closed (their initial value) it moves none, on both sides."""
    ref_cfg, cfg, ref_params, params = _model(name)
    _, pb = _batch(name, 2, 24, 4)
    other = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(pb["frontend"].shape)).astype(np.float32))
    moved = {}
    for what, p in (("open", params), ("closed", _port_gates(params, 0.0))):
        a = forward(cfg, p, pb["tokens"], frontend_embeds=pb["frontend"])
        b = forward(cfg, p, pb["tokens"], frontend_embeds=other)
        moved[what] = float((a["logits"] - b["logits"]).abs().max())
    assert moved["open"] > 1e-2 and moved["closed"] == 0.0
    for value, check in ((0.0, lambda m: m == 0.0), (1.0, lambda m: m > 1e-2)):
        rp = _set_gates(ref_params, value)
        a = ref_forward(ref_cfg, rp, np.asarray(pb["tokens"]),
                        frontend_embeds=jnp.asarray(pb["frontend"].numpy()))
        b = ref_forward(ref_cfg, rp, np.asarray(pb["tokens"]),
                        frontend_embeds=jnp.asarray(other.numpy()))
        assert check(float(jnp.abs(a["logits"] - b["logits"]).max())), value
    with pytest.raises(ValueError, match="frontend_embeds"):
        forward(cfg, params, pb["tokens"])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_equal_the_forward(name):
    """64 tokens, the last 4 decoded against the grouped cross cache; each
    position's logits within 2e-3 abs + 1e-2 rel of the full forward's,
    and the prefill's caches equal to the reference's."""
    ref_cfg, cfg, ref_params, params = _model(name)
    rb, pb = _batch(name, 2, 64, 6)
    s = 64
    groups = cfg.num_layers // cfg.cross_attn_every
    full = forward(cfg, params, pb["tokens"],
                   frontend_embeds=pb["frontend"])["logits"]
    prompt = {"tokens": pb["tokens"][:, :s - 4], "frontend": pb["frontend"]}
    logits, cache = serve_prefill(cfg, params, prompt)
    assert set(cache) == {"pos", "attn", "cross"}
    assert tuple(cache["cross"]["k"].shape) == (groups, 2, 16, 1, 32)
    assert tuple(cache["attn"]["k"].shape)[:2] == (cfg.num_layers, 2)
    empty = init_cache(cfg, 2, s, device="cpu")
    assert tuple(empty["cross"]["v"].shape) == (groups, 2, 16, 1, 32)
    want = ref_forward(ref_cfg, ref_params, rb["tokens"][:, :s - 4],
                       frontend_embeds=rb["frontend"], mode="prefill")
    _assert_tree_close(cache["cross"], want["frontend_kv"], atol=1e-5,
                       rtol=1e-5)
    got = forward(cfg, params, prompt["tokens"],
                  frontend_embeds=pb["frontend"], mode="prefill")
    _assert_tree_close(got["cache"], want["cache"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, s - 5].numpy(), atol=2e-3, rtol=1e-2)
    for t in range(s - 4, s):
        logits, cache = serve_step(cfg, params, cache,
                                   pb["tokens"][:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-3, rtol=1e-2, err_msg=str(t))
    assert int(cache["pos"]) == s


@pytest.mark.parametrize("name", NAMES)
def test_generate_greedy_tokens_match_reference(name):
    ref_cfg, cfg, ref_params, params = _model(name)
    rb, pb = _batch(name, 2, 20, 7)
    want = np.asarray(ref_generate(ref_cfg, ref_params, rb["tokens"], 10,
                                   frontend=rb["frontend"]))
    got = generate(cfg, params, pb["tokens"], 10, frontend=pb["frontend"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_distillation_loss_passes_the_frames_to_the_teacher(name):
    """Logit and token distillation (which reads the hiddens) against a
    teacher of another seed (gates open): the port's total and every
    term within 1e-5 of the reference's."""
    ref_cfg, cfg, ref_params, params = _model(name)
    ref_teacher = _set_gates(ref_model_init(ref_cfg, jax.random.key(1))[0],
                             1.0)
    teacher = params_from_numpy(_np(ref_teacher), device="cpu")
    rb, pb = _batch(name, 2, 32, 8)
    kw = dict(l_task=1.0, l_logit=1.0, l_token=0.5)
    want_total, want = ref_distillation_loss(ref_cfg, ref_params,
                                             ref_teacher, rb, **kw)
    got_total, got = distillation_loss(cfg, params, teacher, pb, **kw)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(got["logit_kl"]) > 0.0 and float(got["token_l2"]) > 0.0


# ----------------------------------------------------------------------
# the self layers' units through the pipeline
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_registry_holds_the_self_layers_units_only(name):
    ref_cfg, cfg, _, _ = _model(name)
    mods = registry(cfg)
    assert [dataclasses.asdict(m) for m in mods] == \
        [dataclasses.asdict(m) for m in ref_registry(ref_cfg)]
    assert [m.name for m in mods] == [f"L{i}.{k}"
                                      for i in range(cfg.num_layers)
                                      for k in ("attn", "ffn")]


@functools.lru_cache(maxsize=None)
def _ref_hessians(name, n, seq):
    ref_cfg, _, ref_params, _ = _model(name)
    calib = ref_calibration_batches(ref_cfg, n, seq, batch=8)
    return calib, ref_collect_hessians(ref_cfg, ref_params, calib)


@pytest.mark.parametrize("name", NAMES)
def test_hessians_match_reference(name):
    _, cfg, _, params = _model(name)
    _, want_h = _ref_hessians(name, 8, 48)
    calib = calibration_batches(cfg, 8, 48, batch=8)
    got = hessian.collect_hessians(cfg, params, calib, device="cpu")
    assert set(got) == set(want_h)
    for mod, want in want_h.items():
        want = np.asarray(want)
        np.testing.assert_allclose(got[mod].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=mod)


@pytest.mark.parametrize("name", NAMES)
def test_database_from_reference_hessians_matches_reference(name):
    """The reference's Hessians of 16 x 64 calibration tokens (1024 rows,
    4 for each of an FFN's 256 inputs; at 8 x 48 late FFN removals are
    near-ties that fp32 rounding orders differently in the two packages,
    tests/test_torch_encdec.py)."""
    ref_cfg, cfg, ref_params, params = _model(name)
    _, ref_hess = _ref_hessians(name, 16, 64)
    want_db = ref_database.build_database(ref_cfg, ref_params, ref_hess)
    hess = {k: torch.from_numpy(np.array(v)) for k, v in ref_hess.items()}
    port_db = database.build_database(cfg, params, hess, device="cpu")
    assert list(port_db) == list(want_db)
    for mod, w in want_db.items():
        g = port_db[mod]
        np.testing.assert_array_equal(g.levels, w.levels)
        np.testing.assert_array_equal(g.order, w.order, err_msg=mod)
        np.testing.assert_allclose(g.errors, w.errors, rtol=1e-3, atol=1e-6,
                                   err_msg=mod)
        np.testing.assert_allclose(g.snapshots.astype(np.float32),
                                   w.snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=mod)


@pytest.mark.parametrize("name", NAMES)
def test_oneshot_prune_assignments_match_reference(name):
    """Both packages' ``oneshot_prune`` on the same weights and
    calibration batches (frames included), the same cost-model table and
    search: identical assignments and speedups, the calibration losses
    (the SPDY scorer's stitched forwards carry the frames) within 1e-4;
    the cross layers and ``frontend_proj`` of every member are the dense
    model's."""
    ref_cfg, cfg, ref_params, params = _model(name)
    ref_calib, _ = _ref_hessians(name, 8, 48)
    kw = dict(search_steps=24, search_pop=8, seed=0)
    want = ref_oneshot_prune(ref_cfg, ref_params, ref_calib,
                             RefEnv(hw=TPU_V5E, **ENV_KW), TARGETS, **kw)
    res = oneshot_prune(cfg, params, calibration_batches(cfg, 8, 48, batch=8),
                        InferenceEnv(hw=HW, **ENV_KW), TARGETS, device="cpu",
                        **kw)
    assert list(res.db) == list(want.db)
    np.testing.assert_allclose(res.dense_loss, want.dense_loss, rtol=1e-4)
    kept = [k for k in ("cross", "frontend_proj") if k in params]
    for t in TARGETS:
        v, w = res.variants[t], want.variants[t]
        assert v.assignment == w.assignment, t
        assert v.speedup >= t and v.speedup == pytest.approx(w.speedup)
        np.testing.assert_allclose(v.calib_loss, w.calib_loss, rtol=1e-4)
        for (path, got), (_, dense) in zip(
                _paths({k: v.params[k] for k in kept}),
                _paths({k: params[k] for k in kept})):
            assert torch.equal(got, dense), (t, path)


# ----------------------------------------------------------------------
# what the port refuses
# ----------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["shrink", "shrink_from_stitched",
                                   "forward_pruned", "gradual_prune"])
def test_shrunk_model_entry_points_refuse_cross_layers(entry):
    """The reference's shrunk VLM keeps only the self layers (its
    ``shrink`` drops ``cross`` and ``frontend_proj``, its forward_pruned
    ignores the frames); the port refuses up front instead of silently
    losing the cross layers."""
    _, cfg, _, params = _model("two_groups")
    a = {m.name: 0 for m in registry(cfg)}
    calls = {
        "shrink": lambda: shrink(cfg, params, {}, a, device="cpu"),
        "shrink_from_stitched": lambda: shrink_from_stitched(
            cfg, params, {}, a),
        "forward_pruned": lambda: forward_pruned(
            PrunedModel(cfg=cfg, layers=[], globals_={}),
            torch.zeros((1, 4), dtype=torch.long)),
        "gradual_prune": lambda: gradual_prune(
            cfg, params, InferenceEnv(hw=HW, **ENV_KW), [1.5], iter(()),
            [], device="cpu"),
    }
    with pytest.raises(NotImplementedError,
                       match=f"^{entry}.*cross-attention layer.*cross.*"
                             "frontend_proj"):
        calls[entry]()


REFUSED = [
    ({"family": "ssm", "attention": "none", "ssm_state": 16},
     "cross_attn_every in the ssm family"),
    ({"hybrid": True, "ssm_state": 16}, "cross_attn_every with hybrid"),
    ({"encoder_decoder": True, "num_encoder_layers": 2},
     "cross_attn_every with encoder_decoder"),
    ({"num_layers": 3}, "num_layers not a multiple of cross_attn_every"),
    ({"cross_attn_every": 0}, "vision_stub without cross_attn_every"),
    ({"frontend": "none"},
     "cross_attn_every without the vision_stub frontend"),
]


@pytest.mark.parametrize("kw,why", REFUSED, ids=[w for _, w in REFUSED])
def test_unsupported_cross_combinations_are_refused(kw, why):
    cfg = smoke_config(ARCH)
    check_supported(cfg)
    check_supported(cfg.replace(num_experts=4, num_experts_per_tok=2))
    with pytest.raises(NotImplementedError, match=why):
        check_supported(cfg.replace(**kw))
    with pytest.raises(NotImplementedError, match=why):
        model_init(cfg.replace(**kw), device="cpu")


def test_serving_engine_refuses_cross_layers():
    _, cfg, _, params = _model("smoke")
    with pytest.raises(NotImplementedError):
        DenseServeModel(cfg, params, 64)
