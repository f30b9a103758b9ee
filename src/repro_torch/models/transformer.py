"""Transformer stack: init, full-sequence forward (train / prefill) and
single-token decode for dense self-attention models (GPT-2/BERT/llama-style
blocks).

Per-layer weights are stacked along a leading layer axis, as in the JAX
package; the forward and decode are Python loops over layers where the
reference scans. MoE, SSM, cross-attention and frontends are not ported
yet and are rejected up front.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..runtime.device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import ffn as ffn_mod
from .layers import (apply_norm, compute_dtype, dense_init, embed_tokens,
                     embedding_init, norm_init, unembed)


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


def _self_block(cfg, lp, x, *, build_cache: bool, capture: bool):
    """One standard block. Returns (x, cache_kv, captures)."""
    cap_attn = {} if capture else None
    h = apply_norm(cfg, lp["ln1"], x)
    a, kv = attn_mod.self_attention(cfg, lp["attn"], h, capture=cap_attn)
    cache_kv = (kv["k"], kv["v"]) if build_cache else None
    x = x + a
    h2 = apply_norm(cfg, lp["ln2"], x)
    cap_ffn = {} if capture else None
    x = x + ffn_mod.ffn_apply(cfg, lp["ffn"], h2, capture=cap_ffn)
    return x, cache_kv, {"attn": cap_attn, "ffn": cap_ffn}


def forward(cfg, params, tokens: torch.Tensor, *, mode: str = "train",
            capture: bool = False):
    """Full-sequence forward.

    mode: "train" (logits over all positions) or "prefill" (also returns
    the stacked KV cache ``cache = {k, v}`` of shape (L, B, S, HKV, D),
    ring-rolled for sliding windows). Returns dict(logits (B,S,V) fp32,
    aux, cache?, and with ``capture`` the per-layer module inputs stacked
    as ``captures[group][key]`` with a leading layer axis).
    """
    check_supported(cfg)
    build_cache = mode == "prefill"
    dev = params["embed"]["table"].device
    tokens = tokens.to(dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    caps, ks, vs = [], [], []
    for i in range(cfg.num_layers):
        x, kv, c = _self_block(cfg, _layer(params["layers"], i), x,
                               build_cache=build_cache, capture=capture)
        caps.append(c)
        if build_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    x = apply_norm(cfg, params["final_norm"], x)
    out = {"logits": unembed(cfg, params["embed"], params.get("head", {}), x),
           "aux": torch.zeros((), device=dev)}
    if capture:
        out["captures"] = {
            grp: {key: torch.stack([c[grp][key] for c in caps])
                  for key in caps[0][grp]}
            for grp in ("attn", "ffn")}
    if build_cache:
        out["cache"] = _ring_cache(cfg, torch.stack(ks), torch.stack(vs))
    return out


def _ring_cache(cfg, k, v):
    """(L,B,S,HKV,D) prefill keys -> ring-buffer cache for decode."""
    window = cfg.window_size if cfg.attention == "sliding_window" else 0
    s = k.shape[2]
    if window and s > window:
        k, v = k[:, :, -window:], v[:, :, -window:]
        shift = (s - window) % window
        k = torch.roll(k, shift, dims=2)
        v = torch.roll(v, shift, dims=2)
    return {"k": k, "v": v}


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, dtype=None, *, kv_heads=None,
               per_slot: bool = False, device: DeviceLike = None):
    """Decode caches for the whole stack, zeros on ``device``.

    ``kv_heads``: optional per-layer KV-head counts (length
    ``num_layers``, e.g. ``[l.kv_groups for l in PrunedModel.layers]``);
    the cache is then a *list* of per-layer ``{k, v}`` buffers sized by
    the pruned structure (``None`` for a dropped attention module), which
    ``models.pruned.decode_step_pruned`` consumes. Without it the cache
    is the stacked (L, B, Sc, HKV, D) form ``decode_step`` consumes.

    ``per_slot=True`` gives a per-slot position vector ``pos: (B,)``
    (continuous batching) instead of the scalar lockstep position.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    cache: Dict[str, Any] = {"pos": torch.zeros((batch,) if per_slot else (),
                                                dtype=torch.long, device=dev)}
    if kv_heads is not None:
        if len(kv_heads) != cfg.num_layers:
            raise ValueError(f"kv_heads has {len(kv_heads)} entries for "
                             f"{cfg.num_layers} layers")
        shape = (batch, seq_len)
        dh = cfg.resolved_head_dim
        cache["attn"] = [
            None if not h else
            {"k": torch.zeros(shape + (int(h), dh), dtype=dtype, device=dev),
             "v": torch.zeros(shape + (int(h), dh), dtype=dtype, device=dev)}
            for h in kv_heads]
    else:
        cache["attn"] = attn_mod.init_kv_cache(cfg, batch, seq_len,
                                               cfg.num_layers, dtype, dev)
    return cache


def decode_step(cfg, params, cache, tokens):
    """One-token decode. tokens: (B, 1). Returns (logits (B,1,V) fp32,
    new_cache).

    ``cache["pos"]`` is a 0-d tensor (lockstep batch) or a (B,) vector of
    per-slot positions (continuous batching): each slot then embeds,
    RoPE-rotates, writes and masks at its own absolute position. The
    cache's k/v tensors are updated in place; the new cache holds them
    and ``pos + 1``.
    """
    pos = cache["pos"]
    positions = None
    if cfg.pos_emb == "learned":
        positions = pos[:, None] if pos.ndim == 1 else pos[None]
    dev = params["embed"]["table"].device
    x = embed_tokens(cfg, params["embed"], tokens.to(dev),
                     positions=positions)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        layer_cache = {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}
        h = apply_norm(cfg, lp["ln1"], x)
        a, _ = attn_mod.self_attention(cfg, lp["attn"], h, cache=layer_cache,
                                       cache_pos=pos)
        x = x + a
        h2 = apply_norm(cfg, lp["ln2"], x)
        x = x + ffn_mod.ffn_apply(cfg, lp["ffn"], h2)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], params.get("head", {}), x)
    return logits, {**cache, "pos": pos + 1}
