"""The port's encoder/decoder path (Whisper: a bidirectional encoder over
the audio stub's frame embeddings; each decoder block self-attention,
cross-attention to the encoder's output, then the FFN) against the JAX
package, on the reference's smoke Whisper
(``smoke_config("whisper-large-v3")``: 2 decoder and 2 encoder layers,
d_model 128, 4 heads of 32, d_ff 256, 16 frames of 128, vocab 512) in
fp32, with the reference's weights carried over by the weight bridge.

The cross-attention gates start at zero (``tanh(0) = 0``: the frames
then reach no logit), so every parity check here sets them to 1.0 on
both sides first. Tolerances:

* frontend batches and calibration batches bit-equal;
* the encoder's output and each layer's cross keys/values 1e-5;
* logits 1e-4 abs/rel, captures (``xattn`` included) 1e-5, loss 1e-5
  relative (tests/test_torch_hybrid.py's);
* prefill and decode against the full forward 2e-3 abs + 1e-2 rel (the
  reference's tests/test_models_smoke.py), greedy tokens equal;
* Hessians 1e-5 of their scale (tighter than 1e-3 * sqrt(N));
* the database fed the reference's Hessians: identical removal orders,
  errors 1e-3, snapshots 2e-3 (fp16);
* ``oneshot_prune`` on the cost model: identical assignments and
  speedups, calibration losses 1e-4 relative;
* the distillation loss 1e-5 relative.

``shrink``, ``shrink_from_stitched``, ``forward_pruned`` and
``gradual_prune`` refuse an encoder/decoder config: the pruned runtime
has no encoder and no cross-attention.
"""
import dataclasses

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
from repro.models import attention as ref_attention
from repro.models.transformer import encoder_forward as ref_encoder_forward
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
from repro_torch.models.attention import cross_kv
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.pruned import PrunedModel, forward_pruned
from repro_torch.models.transformer import check_supported, encoder_forward
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.serve import DenseServeModel

REF_WH = ref_smoke_config("whisper-large-v3").replace(dtype="float32")
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


CFG = port_cfg(REF_WH)


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


def _open_gates(params, value=1.0):
    """The reference's params with every cross-attention gate at
    ``value`` (they start at 0, where the frames reach no logit)."""
    layers = dict(params["layers"])
    layers["xattn"] = {**layers["xattn"], "gate": jnp.full_like(
        layers["xattn"]["gate"], value)}
    return {**params, "layers": layers}


def _batch(b, s, seed, step=0):
    """The same batch for both packages: (reference's, port's)."""
    return (ref_make_batch(REF_WH, b, s, seed=seed, step=step),
            make_batch_np(CFG, b, s, seed=seed, step=step))


@pytest.fixture(scope="module")
def ref():
    """Reference weights (gates 1.0), calibration batches and Hessians."""
    params = _open_gates(ref_model_init(REF_WH, jax.random.key(0))[0])
    calib = ref_calibration_batches(REF_WH, 8, 48, batch=8)
    hess = ref_collect_hessians(REF_WH, params, calib)
    return {"params": params, "calib": calib, "hess": hess}


@pytest.fixture(scope="module")
def params(ref):
    return params_from_numpy(_np(ref["params"]), device="cpu")


# ----------------------------------------------------------------------
# the config, the weight bridge, the batches
# ----------------------------------------------------------------------

def test_whisper_is_ported_and_its_smoke_config_is_the_references():
    assert configs.NOT_PORTED == ()
    full = configs.get_config("whisper-large-v3")
    assert full is configs.WHISPER_LARGE_V3
    assert full == port_cfg(ref_get_config("whisper-large-v3"))
    assert (full.num_layers, full.num_encoder_layers, full.d_model,
            full.num_heads, full.num_kv_heads, full.d_ff, full.vocab_size,
            full.num_frontend_tokens, full.frontend_dim) == \
        (32, 32, 1280, 20, 20, 5120, 51866, 1500, 1280)
    smoke = smoke_config("whisper-large-v3")
    assert smoke == port_cfg(ref_smoke_config("whisper-large-v3"))
    assert (smoke.num_encoder_layers, smoke.num_frontend_tokens,
            smoke.frontend_dim) == (2, 16, 128)
    assert full.param_counts() == \
        ref_get_config("whisper-large-v3").param_counts()


def test_model_init_has_the_reference_leaves_and_the_bridge_carries_them(
        ref, params):
    got = model_init(CFG, device="cpu")
    shapes = {p: tuple(t.shape) for p, t in _paths(got)}
    assert shapes == {p: tuple(t.shape) for p, t in _paths(_np(ref["params"]))}
    assert set(got) == {"embed", "layers", "final_norm", "head",
                        "enc_layers", "enc_norm", "enc_pos"}
    assert set(got["layers"]) == {"ln1", "attn", "ln2", "ffn", "lnx",
                                  "xattn"}
    assert set(got["enc_layers"]) == {"ln1", "attn", "ln2", "ffn"}
    # the gate starts closed, as the reference's
    assert torch.equal(got["layers"]["xattn"]["gate"], torch.zeros(2))
    bridged = dict(_paths(params))
    for path, w in _paths(_np(ref["params"])):
        node = bridged[path]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), w, err_msg=path)
    assert torch.equal(params["layers"]["xattn"]["gate"], torch.ones(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_and_calibration_batches_are_the_references_bits(dtype):
    ref_cfg, cfg = REF_WH.replace(dtype=dtype), CFG.replace(dtype=dtype)
    for step in range(3):
        want = ref_make_batch(ref_cfg, 4, 24, seed=5, step=step)
        got = make_batch_np(cfg, 4, 24, seed=5, step=step)
        assert set(got) == set(want) == {"tokens", "frontend"}
        assert got["frontend"].dtype == getattr(torch, dtype)
        assert tuple(got["frontend"].shape) == (4, 16, 128)
        np.testing.assert_array_equal(
            got["frontend"].float().numpy(),
            np.asarray(want["frontend"].astype(jnp.float32)))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    got = calibration_batches(cfg, 12, 32, batch=8)
    want = ref_calibration_batches(ref_cfg, 12, 32, batch=8)
    assert [tuple(b["frontend"].shape) for b in got] == [(8, 16, 128),
                                                         (4, 16, 128)]
    for g, w in zip(got, want):
        for k in ("tokens", "frontend"):
            np.testing.assert_array_equal(
                g[k].float().numpy(), np.asarray(w[k]).astype(np.float32))


def test_vision_frontend_batches_still_raise():
    """The vision stub's frames are drawn as the audio stub's
    (tests/test_torch_vlm.py holds them to the reference's bits); a
    frontend that is neither stub still raises."""
    got = make_batch_np(CFG.replace(frontend="vision_stub"), 2, 8)
    assert tuple(got["frontend"].shape) == (2, 16, 128)
    with pytest.raises(NotImplementedError, match="audio and vision stubs"):
        make_batch_np(CFG.replace(frontend="image_patches"), 2, 8)


# ----------------------------------------------------------------------
# encoder, forward, decode
# ----------------------------------------------------------------------

def test_encoder_output_and_cross_kv_match_reference(ref, params):
    rb, pb = _batch(2, 16, 1)
    want, _ = ref_encoder_forward(REF_WH, ref["params"], rb["frontend"])
    got = encoder_forward(CFG, params, pb["frontend"])
    assert tuple(got.shape) == (2, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for i in range(CFG.num_layers):
        lp = {k: v[i] for k, v in params["layers"]["xattn"].items()}
        rlp = jax.tree.map(lambda a: a[i], ref["params"]["layers"]["xattn"])
        kv = cross_kv(CFG, lp, got)
        assert tuple(kv["k"].shape) == (2, 16, 4, 32)
        _assert_tree_close(kv, ref_attention.cross_kv(REF_WH, rlp, want),
                           atol=1e-5, rtol=1e-5)


def test_forward_logits_captures_and_loss_match_reference(ref, params):
    rb, pb = _batch(2, 40, 2)
    want = ref_forward(REF_WH, ref["params"], rb["tokens"],
                       frontend_embeds=rb["frontend"], capture=True)
    got = forward(CFG, params, pb["tokens"], frontend_embeds=pb["frontend"],
                  capture=True)
    caps, rcaps = got["captures"], _np(want["captures"])
    assert set(caps) == set(rcaps) == {"attn", "xattn", "ffn"}
    assert [p for p, _ in _paths(caps)] == [p for p, _ in _paths(rcaps)]
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    _assert_tree_close(caps, rcaps, atol=1e-5, rtol=1e-5)
    _assert_tree_close(got["cross_kv"], want["cross_kv"], atol=1e-5,
                       rtol=1e-5)
    assert tuple(got["cross_kv"]["k"].shape) == (2, 2, 16, 4, 32)
    rb, pb = _batch(2, 32, 3)
    np.testing.assert_allclose(
        float(loss_fn(CFG, params, pb)["loss"]),
        float(ref_loss_fn(REF_WH, ref["params"], rb)["loss"]), rtol=1e-5)


def test_logits_change_with_the_frames_once_the_gate_opens(ref, params):
    """With the gates open another set of frames moves the logits; with
    them closed (their initial value) it moves none, on both sides."""
    _, pb = _batch(2, 24, 4)
    other = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(pb["frontend"].shape)).astype(np.float32))
    closed = {**params, "layers": {**params["layers"], "xattn": {
        **params["layers"]["xattn"], "gate": torch.zeros(2)}}}
    moved = {}
    for name, p in (("open", params), ("closed", closed)):
        a = forward(CFG, p, pb["tokens"], frontend_embeds=pb["frontend"])
        b = forward(CFG, p, pb["tokens"], frontend_embeds=other)
        moved[name] = float((a["logits"] - b["logits"]).abs().max())
    assert moved["open"] > 1e-2 and moved["closed"] == 0.0
    ref_closed = _open_gates(ref["params"], 0.0)
    a = ref_forward(REF_WH, ref_closed, np.asarray(pb["tokens"]),
                    frontend_embeds=jnp.asarray(pb["frontend"].numpy()))
    b = ref_forward(REF_WH, ref_closed, np.asarray(pb["tokens"]),
                    frontend_embeds=jnp.asarray(other.numpy()))
    assert float(jnp.abs(a["logits"] - b["logits"]).max()) == 0.0
    with pytest.raises(ValueError, match="frontend_embeds"):
        forward(CFG, params, pb["tokens"])


def test_prefill_and_decode_equal_the_forward(ref, params):
    """The reference's tests/test_models_smoke.py decode case: 64 tokens,
    the last 4 decoded against the cross cache; each position's logits
    within 2e-3 abs + 1e-2 rel of the full forward's, and the prefill's
    caches equal to the reference's."""
    rb, pb = _batch(2, 64, 6)
    s = 64
    full = forward(CFG, params, pb["tokens"],
                   frontend_embeds=pb["frontend"])["logits"]
    prompt = {"tokens": pb["tokens"][:, :s - 4], "frontend": pb["frontend"]}
    logits, cache = serve_prefill(CFG, params, prompt)
    assert set(cache) == {"pos", "attn", "cross"}
    assert tuple(cache["cross"]["k"].shape) == (2, 2, 16, 4, 32)
    want = ref_forward(REF_WH, ref["params"], rb["tokens"][:, :s - 4],
                       frontend_embeds=rb["frontend"], mode="prefill")
    _assert_tree_close(cache["cross"], want["cross_kv"], atol=1e-5,
                       rtol=1e-5)
    got = forward(CFG, params, prompt["tokens"],
                  frontend_embeds=pb["frontend"], mode="prefill")
    _assert_tree_close(got["cache"], want["cache"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, s - 5].numpy(), atol=2e-3, rtol=1e-2)
    for t in range(s - 4, s):
        logits, cache = serve_step(CFG, params, cache,
                                   pb["tokens"][:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-3, rtol=1e-2, err_msg=str(t))
    assert int(cache["pos"]) == s


def test_generate_greedy_tokens_match_reference(ref, params):
    rb, pb = _batch(2, 20, 7)
    want = np.asarray(ref_generate(REF_WH, ref["params"], rb["tokens"], 10,
                                   frontend=rb["frontend"]))
    got = generate(CFG, params, pb["tokens"], 10, frontend=pb["frontend"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_distillation_loss_passes_the_frames_to_the_teacher(ref, params):
    """Logit and token distillation against a teacher of another seed
    (gates open): the port's total and every term within 1e-5 of the
    reference's."""
    ref_teacher = _open_gates(ref_model_init(REF_WH, jax.random.key(1))[0])
    teacher = params_from_numpy(_np(ref_teacher), device="cpu")
    rb, pb = _batch(2, 32, 8)
    kw = dict(l_task=1.0, l_logit=1.0, l_token=0.5)
    want_total, want = ref_distillation_loss(REF_WH, ref["params"],
                                             ref_teacher, rb, **kw)
    got_total, got = distillation_loss(CFG, params, teacher, pb, **kw)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(got["logit_kl"]) > 0.0


# ----------------------------------------------------------------------
# the decoder's units through the pipeline
# ----------------------------------------------------------------------

def test_registry_holds_the_decoders_units_only():
    mods = registry(CFG)
    assert [dataclasses.asdict(m) for m in mods] == \
        [dataclasses.asdict(m) for m in ref_registry(REF_WH)]
    assert [m.name for m in mods] == ["L0.attn", "L0.ffn", "L1.attn",
                                      "L1.ffn"]


def test_hessians_match_reference(ref, params):
    calib = calibration_batches(CFG, 8, 48, batch=8)
    got = hessian.collect_hessians(CFG, params, calib, device="cpu")
    assert set(got) == set(ref["hess"])
    for name, want in ref["hess"].items():
        want = np.asarray(want)
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_database_from_reference_hessians_matches_reference(ref, params):
    """The reference's Hessians of 16 x 64 calibration tokens (1024 rows,
    4 for each of an FFN's 256 inputs): at 8 x 48 (384 rows) an FFN
    Hessian's condition number reaches 7e5 and the last 20 of its 256
    removals are near-ties that fp32 rounding orders differently in the
    two packages, as the MoE slice's expert Hessians at that size."""
    ref_hess = ref_collect_hessians(REF_WH, ref["params"],
                                    ref_calibration_batches(REF_WH, 16, 64,
                                                            batch=8))
    want_db = ref_database.build_database(REF_WH, ref["params"], ref_hess)
    hess = {k: torch.from_numpy(np.array(v)) for k, v in ref_hess.items()}
    port_db = database.build_database(CFG, params, hess, device="cpu")
    assert list(port_db) == list(want_db)
    for name, w in want_db.items():
        g = port_db[name]
        np.testing.assert_array_equal(g.levels, w.levels)
        np.testing.assert_array_equal(g.order, w.order, err_msg=name)
        np.testing.assert_allclose(g.errors, w.errors, rtol=1e-3, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g.snapshots.astype(np.float32),
                                   w.snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=name)


def test_oneshot_prune_assignments_match_reference(ref, params):
    """Both packages' ``oneshot_prune`` on the same weights and
    calibration batches (frames included), the same cost-model table and
    search: identical assignments and speedups, the calibration losses
    (the SPDY scorer's stitched forwards carry the frames) within 1e-4;
    the encoder and the cross-attention of every member are the dense
    model's."""
    kw = dict(search_steps=24, search_pop=8, seed=0)
    want = ref_oneshot_prune(REF_WH, ref["params"], ref["calib"],
                             RefEnv(hw=TPU_V5E, **ENV_KW), TARGETS, **kw)
    res = oneshot_prune(CFG, params, calibration_batches(CFG, 8, 48, batch=8),
                        InferenceEnv(hw=HW, **ENV_KW), TARGETS, device="cpu",
                        **kw)
    assert list(res.db) == list(want.db)
    np.testing.assert_allclose(res.dense_loss, want.dense_loss, rtol=1e-4)
    for t in TARGETS:
        v, w = res.variants[t], want.variants[t]
        assert v.assignment == w.assignment, t
        assert v.speedup >= t and v.speedup == pytest.approx(w.speedup)
        np.testing.assert_allclose(v.calib_loss, w.calib_loss, rtol=1e-4)
        kept = {"enc_layers": v.params["enc_layers"],
                "xattn": v.params["layers"]["xattn"],
                "lnx": v.params["layers"]["lnx"]}
        dense = {"enc_layers": params["enc_layers"],
                 "xattn": params["layers"]["xattn"],
                 "lnx": params["layers"]["lnx"]}
        for (path, got), (_, ref_leaf) in zip(_paths(kept), _paths(dense)):
            assert torch.equal(got, ref_leaf), (t, path)


# ----------------------------------------------------------------------
# what the port refuses for an encoder/decoder model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["shrink", "shrink_from_stitched",
                                   "forward_pruned", "gradual_prune"])
def test_shrunk_model_entry_points_refuse_encoder_decoder(params, entry):
    """The reference's shrunk Whisper keeps only the decoder's
    self-attention and FFN (its forward_pruned ignores the frames); the
    port refuses up front instead of silently losing the encoder and the
    cross-attention."""
    a = {m.name: 0 for m in registry(CFG)}
    calls = {
        "shrink": lambda: shrink(CFG, params, {}, a, device="cpu"),
        "shrink_from_stitched": lambda: shrink_from_stitched(
            CFG, params, {}, a),
        "forward_pruned": lambda: forward_pruned(
            PrunedModel(cfg=CFG, layers=[], globals_={}),
            torch.zeros((1, 4), dtype=torch.long)),
        "gradual_prune": lambda: gradual_prune(
            CFG, params, InferenceEnv(hw=HW, **ENV_KW), [1.5], iter(()),
            [], device="cpu"),
    }
    with pytest.raises(NotImplementedError,
                       match="encoder/decoder.*encoder.*cross-attention"):
        calls[entry]()


def test_serving_engine_and_grouped_cross_layers_are_refused(params):
    with pytest.raises(NotImplementedError):
        DenseServeModel(CFG, params, 64)
    check_supported(CFG)
    for kw, why in (
            ({"cross_attn_every": 5},
             "cross_attn_every with encoder_decoder"),
            ({"frontend": "vision_stub"},
             "encoder_decoder without the audio_stub frontend.*"
             "vision_stub without cross_attn_every"),
            ({"encoder_decoder": False}, "audio_stub without encoder_decoder"),
            ({"num_experts": 4}, "encoder_decoder with experts")):
        with pytest.raises(NotImplementedError, match=why):
            check_supported(CFG.replace(**kw))
