"""The port's data stream and dense forward against the JAX package, on
the same tokens and the same weights (moved over by the weight bridge).

Tolerances: fp32 on both sides; the two frameworks sum in different
orders, so logits and captures agree to ~1e-5 relative. 1e-4 absolute
(and relative) leaves a decade of room, and the loss is held to 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.data import calibration_batches as ref_calibration_batches
from repro.data.synthetic import make_batch_np as ref_make_batch
from repro.models import model_init as ref_model_init
from repro.models.model import loss_fn as ref_loss_fn
from repro.models.transformer import forward as ref_forward
from repro_torch.configs import ModelConfig
from repro_torch.data import calibration_batches, make_batch_np
from repro_torch.models import forward, loss_fn, model_init
from repro_torch.models.convert import params_from_numpy

# the quickstart's gpt2-tiny (examples/quickstart.py), two layers
REF_TINY = REF_GPT2.replace(name="gpt2-tiny", num_layers=2, d_model=96,
                            d_ff=384, num_heads=6, num_kv_heads=6,
                            head_dim=16, vocab_size=384, dtype="float32")
# a llama-style variant: RoPE, RMSNorm, SwiGLU, GQA, untied head
REF_LLAMA = REF_TINY.replace(name="llama-tiny", norm="rmsnorm",
                             pos_emb="rope", ffn_activation="swiglu",
                             num_kv_heads=2, tie_embeddings=False)
# bidirectional masked-LM variant (BERT-style)
REF_BERT = REF_TINY.replace(name="bert-tiny", causal=False)
CASES = {"gpt2": REF_TINY, "llama": REF_LLAMA, "bert": REF_BERT}


# the JAX package's tracing and tiling options, which the port's config
# does not carry
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")


def port_cfg(ref_cfg):
    """The port's config of a reference config, field for field."""
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


def bridge(ref_params):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params),
                             device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_logits_loss_and_captures_match_reference(case):
    ref_cfg = CASES[case]
    cfg = port_cfg(ref_cfg)
    ref_params = ref_model_init(ref_cfg, jax.random.key(3))[0]
    params = bridge(ref_params)
    ref_batch = ref_make_batch(ref_cfg, 2, 24, seed=5)
    batch = make_batch_np(cfg, 2, 24, seed=5)

    want = ref_forward(ref_cfg, ref_params, ref_batch["tokens"], capture=True)
    got = forward(cfg, params, batch["tokens"], capture=True)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]),
                               atol=1e-4, rtol=1e-4)
    for grp, key in (("attn", "wo_in"), ("ffn", "wd_in")):
        w = np.asarray(want["captures"][grp][key])
        g = got["captures"][grp][key].numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{grp}.{key}")

    want_loss = float(ref_loss_fn(ref_cfg, ref_params, ref_batch)["loss"])
    got_loss = float(loss_fn(cfg, params, batch)["loss"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_are_bit_identical(case):
    ref_cfg = CASES[case]
    cfg = port_cfg(ref_cfg)
    ref_calib = ref_calibration_batches(ref_cfg, 20, 16, batch=8)
    calib = calibration_batches(cfg, 20, 16, batch=8)
    assert [b["tokens"].shape[0] for b in calib] == [8, 8, 4]
    for rb, b in zip(ref_calib, calib):
        assert sorted(rb) == sorted(b)
        for k in rb:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(rb[k]))


def test_model_init_is_seeded_and_shaped():
    cfg = port_cfg(REF_TINY)
    a = model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    ref_shapes = jax.tree.map(
        lambda x: x.shape, ref_model_init(REF_TINY, jax.random.key(0))[0])
    got_shapes = jax.tree.map(lambda x: tuple(x.shape), a)
    assert got_shapes == ref_shapes
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    # truncated at two standard deviations of the fan-in scale
    wo = a["layers"]["attn"]["wo"]
    assert float(wo.abs().max()) <= 2.0 / np.sqrt(wo.shape[1]) + 1e-6


def test_unported_families_are_rejected():
    """MoE, the hybrid block and grouped cross layers are ported
    (tests/test_torch_moe.py, tests/test_torch_hybrid.py,
    tests/test_torch_vlm.py): a hybrid model initialises with its SSD
    leaves beside the attention's, a grouped cross stack with one
    ``cross`` module per group of ``cross_attn_every`` layers. A depth
    that is not a multiple of ``cross_attn_every`` is refused."""
    hybrid = model_init(port_cfg(REF_TINY).replace(hybrid=True,
                                                   ssm_state=16),
                        device="cpu")
    assert {"attn", "ffn", "ssm"} <= set(hybrid["layers"])
    vlm = port_cfg(REF_TINY).replace(
        num_layers=4, cross_attn_every=2, frontend="vision_stub",
        num_frontend_tokens=8, frontend_dim=REF_TINY.d_model)
    grouped = model_init(vlm, device="cpu")
    assert tuple(grouped["cross"]["lnx"]["scale"].shape) == \
        (2, REF_TINY.d_model)
    assert tuple(grouped["cross"]["xattn"]["gate"].shape) == (2,)
    assert "frontend_proj" not in grouped
    with pytest.raises(NotImplementedError,
                       match="num_layers not a multiple of cross_attn_every"):
        model_init(vlm.replace(num_layers=3), device="cpu")
