"""Model configurations of the PyTorch port: the reference's registry of
the architectures the port runs.

Each module holds one architecture's published dimensions, copied from
the JAX package's module of the same name. ``ARCHS`` lists exactly the
configs whose every layer the port runs; ``get_config`` raises for any
other name, and names the reference's architectures that are not ported
yet. ``smoke_config`` gives the reduced same-family config the tests run
on the CPU, ``shapes_for`` the input-shape cells assigned to an
architecture.
"""
from __future__ import annotations

from .base import (DECODE_32K, LM_SHAPES, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ModelConfig, ShapeConfig)
from .bert import BERT_BASE, BERT_LARGE
from .dbrx_132b import CONFIG as DBRX_132B
from .gpt2 import GPT2_SMALL
from .h2o_danube_1p8b import CONFIG as H2O_DANUBE_1P8B
from .hymba_1p5b import CONFIG as HYMBA_1P5B
from .internlm2_20b import CONFIG as INTERNLM2_20B
from .llama32_vision_11b import CONFIG as LLAMA32_VISION_11B
from .mamba2_2p7b import MAMBA2_2P7B
from .phi35_moe_42b import CONFIG as PHI35_MOE
from .qwen15_110b import CONFIG as QWEN15_110B
from .qwen2_72b import CONFIG as QWEN2_72B
from .whisper_large_v3 import CONFIG as WHISPER_LARGE_V3

ARCHS = {
    c.name: c for c in [
        DBRX_132B, PHI35_MOE, MAMBA2_2P7B, LLAMA32_VISION_11B,
        H2O_DANUBE_1P8B, QWEN15_110B, QWEN2_72B, INTERNLM2_20B,
        WHISPER_LARGE_V3, HYMBA_1P5B, BERT_BASE, BERT_LARGE, GPT2_SMALL,
    ]
}

# the reference's assigned architectures (its list verbatim); any in
# NOT_PORTED would stay refused by get_config
ASSIGNED = [
    "dbrx-132b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
    "llama-3.2-vision-11b", "h2o-danube-1.8b", "qwen1.5-110b", "qwen2-72b",
    "internlm2-20b", "whisper-large-v3", "hymba-1.5b",
]

# the reference's architectures whose paths the port does not run yet
# (none: every assigned architecture is ported)
NOT_PORTED = ()

# archs with sub-quadratic attention for which long_500k is runnable
SUBQUADRATIC = {"mamba2-2.7b", "hymba-1.5b", "h2o-danube-1.8b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}; "
                       f"not ported yet: {list(NOT_PORTED)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's)."""
    c = get_config(name)
    kw = dict(
        name=c.name + "-smoke", num_layers=2, d_model=128,
        d_ff=256 if c.d_ff else 0, vocab_size=512, max_position=4096,
    )
    if c.attention != "none":
        kw.update(num_heads=4, num_kv_heads=max(1, 4 // max(c.q_per_kv, 1)),
                  head_dim=32)
        if c.num_kv_heads == c.num_heads:
            kw["num_kv_heads"] = 4
    if c.num_experts:
        kw.update(num_experts=4,
                  num_experts_per_tok=min(2, c.num_experts_per_tok))
    if c.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
                  ssm_expand=max(1, c.ssm_expand))
    if c.encoder_decoder:
        kw.update(num_encoder_layers=2, num_frontend_tokens=16,
                  frontend_dim=128)
    if c.cross_attn_every:
        kw.update(cross_attn_every=2, num_frontend_tokens=16,
                  frontend_dim=128)
    if c.attention == "sliding_window":
        kw.update(window_size=64)
    return c.replace(**kw)


def shapes_for(name: str):
    """The shape cells assigned to an arch: every LM shape, less
    long_500k for a full-attention arch."""
    return [s for s in LM_SHAPES
            if s.name != "long_500k" or name in SUBQUADRATIC]


__all__ = ["ARCHS", "ASSIGNED", "BERT_BASE", "BERT_LARGE", "DBRX_132B",
           "DECODE_32K", "GPT2_SMALL", "H2O_DANUBE_1P8B", "HYMBA_1P5B",
           "INTERNLM2_20B", "LLAMA32_VISION_11B", "LM_SHAPES", "LONG_500K",
           "MAMBA2_2P7B",
           "ModelConfig", "NOT_PORTED", "PHI35_MOE", "PREFILL_32K",
           "QWEN15_110B", "QWEN2_72B", "SUBQUADRATIC", "ShapeConfig",
           "TRAIN_4K", "WHISPER_LARGE_V3", "get_config", "shapes_for",
           "smoke_config"]
