"""Transformer stack: init and full-sequence forward for dense
self-attention models (GPT-2/BERT/llama-style blocks).

Per-layer weights are stacked along a leading layer axis, as in the JAX
package; the forward is a Python loop over layers where the reference
scans. MoE, SSM, cross-attention, frontends and the KV cache are not
ported yet and are rejected up front.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..runtime.device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import ffn as ffn_mod
from .layers import (apply_norm, dense_init, embed_tokens, embedding_init,
                     norm_init, unembed)


def check_supported(cfg) -> None:
    unsupported = {
        "num_experts": cfg.num_experts, "ssm_state": cfg.ssm_state,
        "hybrid": cfg.hybrid, "encoder_decoder": cfg.encoder_decoder,
        "cross_attn_every": cfg.cross_attn_every,
        "attention='none'": cfg.attention == "none",
        "frontend": cfg.frontend != "none",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense self-attention stacks only "
            f"(not ported yet: {', '.join(bad)})")


def model_init(cfg, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded fp32 parameters on ``device``. Weights are drawn on the CPU
    generator (default seed 0), so a seed gives the same model on every
    device."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    L = cfg.num_layers
    params: Dict[str, Any] = {
        "embed": embedding_init(cfg, g),
        "layers": {
            "ln1": norm_init(cfg, L),
            "attn": attn_mod.attention_init(cfg, g, L),
            "ln2": norm_init(cfg, L),
            "ffn": ffn_mod.ffn_init(cfg, g, L),
        },
        "final_norm": norm_init(cfg),
        "head": ({} if cfg.tie_embeddings else
                 {"w": dense_init((cfg.vocab_size, cfg.d_model), g,
                                  in_axis=-1)}),
    }
    return tree_to(params, dev)


def tree_to(tree, device, dtype=None):
    """Move (and optionally cast) every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def _layer(layers, i: int):
    return {grp: {leaf: t[i] for leaf, t in sub.items()}
            for grp, sub in layers.items()}


def _self_block(cfg, lp, x, *, capture: bool):
    cap_attn = {} if capture else None
    h = apply_norm(cfg, lp["ln1"], x)
    x = x + attn_mod.self_attention(cfg, lp["attn"], h, capture=cap_attn)
    h2 = apply_norm(cfg, lp["ln2"], x)
    cap_ffn = {} if capture else None
    x = x + ffn_mod.ffn_apply(cfg, lp["ffn"], h2, capture=cap_ffn)
    return x, {"attn": cap_attn, "ffn": cap_ffn}


def forward(cfg, params, tokens: torch.Tensor, *, capture: bool = False):
    """Full-sequence forward. Returns dict(logits (B,S,V) fp32, aux, and
    with ``capture`` the per-layer module inputs stacked as
    ``captures[group][key]`` with a leading layer axis)."""
    check_supported(cfg)
    dev = params["embed"]["table"].device
    tokens = tokens.to(dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    caps = []
    for i in range(cfg.num_layers):
        x, c = _self_block(cfg, _layer(params["layers"], i), x,
                           capture=capture)
        caps.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    out = {"logits": unembed(cfg, params["embed"], params.get("head", {}), x),
           "aux": torch.zeros((), device=dev)}
    if capture:
        out["captures"] = {
            grp: {key: torch.stack([c[grp][key] for c in caps])
                  for key in caps[0][grp]}
            for grp in ("attn", "ffn")}
    return out
