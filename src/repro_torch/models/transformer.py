"""Transformer stack: init, full-sequence forward (train / prefill) and
single-token decode for dense self-attention models (GPT-2/BERT/llama-style
blocks), mixture-of-experts models (the FFN of every block a
``models.moe`` layer), Mamba-2 (SSD) stacks and Hymba-style hybrid
stacks (attention and SSD heads side by side on the block's normed
input, their outputs averaged, then the FFN).

Per-layer weights are stacked along a leading layer axis, as in the JAX
package; the forward and decode are Python loops over layers where the
reference scans. Cross-attention, encoder/decoder stacks and frontends
are not ported yet and are rejected up front.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..runtime.device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (apply_norm, compute_dtype, dense_init, embed_tokens,
                     embedding_init, norm_init, unembed)


def check_supported(cfg) -> None:
    ssm = cfg.family == "ssm"
    unsupported = {
        "num_experts in the ssm family": cfg.num_experts and ssm,
        "hybrid in the ssm family": cfg.hybrid and ssm,
        "ssm_state outside the ssm family and hybrid blocks":
            cfg.ssm_state and not (ssm or cfg.hybrid),
        "family='ssm' without ssm_state": ssm and not cfg.ssm_state,
        "hybrid without ssm_state": cfg.hybrid and not cfg.ssm_state,
        "encoder_decoder": cfg.encoder_decoder,
        "cross_attn_every": cfg.cross_attn_every,
        "attention='none'": cfg.attention == "none" and not ssm,
        "frontend": cfg.frontend != "none",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense and MoE self-attention, "
            f"Mamba-2 and hybrid attention + SSD stacks only (not ported "
            f"yet: {', '.join(bad)})")


def block_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "ssm"
    return "hybrid" if cfg.hybrid else "self"


def model_init(cfg, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded fp32 parameters on ``device``. Weights are drawn on the CPU
    generator (default seed 0), so a seed gives the same model on every
    device."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    L = cfg.num_layers
    kind = block_kind(cfg)
    embed = embedding_init(cfg, g)
    if kind == "ssm":
        layers = {"ln1": norm_init(cfg, L),
                  "ssm": ssm_mod.ssm_init(cfg, g, L)}
    else:
        layers = {"ln1": norm_init(cfg, L),
                  "attn": attn_mod.attention_init(cfg, g, L),
                  "ln2": norm_init(cfg, L)}
        if cfg.num_experts:
            layers["moe"] = moe_mod.moe_init(cfg, g, L)
        else:
            layers["ffn"] = ffn_mod.ffn_init(cfg, g, L)
        if kind == "hybrid":  # drawn last, as the reference's _block_init
            layers["ssm"] = ssm_mod.ssm_init(cfg, g, L)
    params: Dict[str, Any] = {
        "embed": embed,
        "layers": layers,
        "final_norm": norm_init(cfg),
        "head": ({} if cfg.tie_embeddings else
                 {"w": dense_init((cfg.vocab_size, cfg.d_model), g,
                                  in_axis=-1)}),
    }
    return tree_to(params, dev)


def tree_to(tree, device, dtype=None):
    """Move (and optionally cast) every tensor of a nested dict (or of a
    named tuple of them, such as a ``TrainState``; ``None`` stays)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, device, dtype) for v in tree))
    if tree is None:
        return None
    return tree.to(device=device, dtype=dtype)


def _layer(layers, i: int):
    return {grp: {leaf: t[i] for leaf, t in sub.items()}
            for grp, sub in layers.items()}


def _ffn_or_moe(cfg, lp, h2, capture=None):
    """The block's FFN: a dense FFN, or an MoE layer (whose captures
    ``wd_in``/``wd_valid`` the reference also files under ``ffn``).
    Returns (y, aux)."""
    if cfg.num_experts:
        return moe_mod.moe_apply(cfg, lp["moe"], h2, capture=capture)
    return ffn_mod.ffn_apply(cfg, lp["ffn"], h2, capture=capture), None


def _ssm_branch(cfg, lp, h, *, build_cache: bool, caps):
    """The SSD heads on a block's normed input: (y, its decode cache or
    None). Writes ``ssm_out_in`` into ``caps`` (the layer's captures,
    where the reference files it) unless ``caps`` is None."""
    y = ssm_mod.ssm_apply(cfg, lp["ssm"], h, capture=caps,
                          return_cache=build_cache)
    return y if build_cache else (y, None)


def _self_block(cfg, lp, x, *, build_cache: bool, capture: bool):
    """One standard block, or a hybrid one: attention and the SSD heads on
    the same normed input, ``0.5 * (attn + ssm)`` into the residual (the
    reference's ``_self_block``). Returns (x, aux, cache_kv, cache_ssm,
    captures)."""
    caps: Dict[str, Any] = {}
    cap_attn = {} if capture else None
    h = apply_norm(cfg, lp["ln1"], x)
    a, kv = attn_mod.self_attention(cfg, lp["attn"], h, capture=cap_attn)
    cache_kv = (kv["k"], kv["v"]) if build_cache else None
    cache_ssm = None
    if "ssm" in lp:
        m, cache_ssm = _ssm_branch(cfg, lp, h, build_cache=build_cache,
                                   caps=caps if capture else None)
        a = 0.5 * (a + m)
    x = x + a
    h2 = apply_norm(cfg, lp["ln2"], x)
    cap_ffn = {} if capture else None
    f, aux = _ffn_or_moe(cfg, lp, h2, capture=cap_ffn)
    caps.update(attn=cap_attn, ffn=cap_ffn)
    return x + f, aux, cache_kv, cache_ssm, caps


def _ssm_block(cfg, lp, x, *, build_cache: bool, capture: bool):
    """One Mamba-2 block. Returns (x, aux, None, cache_ssm, captures); the
    capture ``ssm_out_in`` sits at the layer level, as in the reference."""
    caps: Dict[str, Any] = {}
    h = apply_norm(cfg, lp["ln1"], x)
    y, cache = _ssm_branch(cfg, lp, h, build_cache=build_cache,
                           caps=caps if capture else None)
    return x + y, None, None, cache, caps


def _stack(trees):
    """Per-layer trees (nested dicts of tensors) -> one tree of stacked
    tensors with a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def forward(cfg, params, tokens: torch.Tensor, *, mode: str = "train",
            capture: bool = False, collect_hiddens: bool = False):
    """Full-sequence forward.

    mode: "train" (logits over all positions) or "prefill" (also returns
    the decode cache: for attention stacks ``cache = {k, v}`` of shape
    (L, B, S, HKV, D), ring-rolled for sliding windows; for SSM stacks
    ``cache_ssm = {state, conv_x, conv_bc}`` stacked over layers; a
    hybrid stack returns both).
    Returns dict(logits (B,S,V) fp32, aux (the mean over layers of the
    MoE load-balancing loss; 0 without experts), the cache, and with
    ``capture`` the per-layer module inputs stacked with a leading layer
    axis: ``captures[group][key]`` for attention stacks (an MoE layer's
    ``captures["ffn"]["wd_in"]`` is (L, E, C, f), with
    ``captures["ffn"]["wd_valid"]`` (L, E, C)), ``captures["ssm_out_in"]``
    for SSM stacks, both for hybrid stacks). With ``collect_hiddens``,
    ``hiddens`` is each layer's output stacked to (L, B, S, d), as the
    reference's ``_scan_stack`` collects them (token distillation reads
    them).
    """
    check_supported(cfg)
    build_cache = mode == "prefill"
    dev = params["embed"]["table"].device
    tokens = tokens.to(dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    block = _ssm_block if block_kind(cfg) == "ssm" else _self_block
    caps, kv_caches, ssm_caches, auxes, hiddens = [], [], [], [], []
    for i in range(cfg.num_layers):
        x, aux, c_kv, c_ssm, c = block(cfg, _layer(params["layers"], i), x,
                                       build_cache=build_cache,
                                       capture=capture)
        caps.append(c)
        kv_caches.append(c_kv)
        ssm_caches.append(c_ssm)
        if aux is not None:
            auxes.append(aux)
        if collect_hiddens:
            hiddens.append(x)
    x = apply_norm(cfg, params["final_norm"], x)
    out = {"logits": unembed(cfg, params["embed"], params.get("head", {}), x),
           "aux": (torch.stack(auxes).mean() if auxes
                   else torch.zeros((), device=dev))}
    if collect_hiddens:
        out["hiddens"] = torch.stack(hiddens)
    if capture:
        out["captures"] = _stack(caps)
    if build_cache and kv_caches[0] is not None:
        out["cache"] = _ring_cache(cfg, torch.stack([c[0] for c in kv_caches]),
                                   torch.stack([c[1] for c in kv_caches]))
    if build_cache and ssm_caches[0] is not None:
        out["cache_ssm"] = _stack(ssm_caches)
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
    (continuous batching) instead of the scalar lockstep position. An SSM
    stack's cache is ``ssm = {state, conv_x, conv_bc}`` stacked over
    layers instead of k/v buffers; a hybrid stack's holds both.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    kind = block_kind(cfg)
    cache: Dict[str, Any] = {"pos": torch.zeros((batch,) if per_slot else (),
                                                dtype=torch.long, device=dev)}
    if kind in ("ssm", "hybrid"):
        cache["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, cfg.num_layers,
                                              dtype, dev)
    if kind == "ssm":
        return cache
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
    cache's k/v (or SSM state and conv) tensors are updated in place; the
    new cache holds them and ``pos + 1``.
    """
    pos = cache["pos"]
    positions = None
    if cfg.pos_emb == "learned":
        positions = pos[:, None] if pos.ndim == 1 else pos[None]
    dev = params["embed"]["table"].device
    x = embed_tokens(cfg, params["embed"], tokens.to(dev),
                     positions=positions)
    kind = block_kind(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = apply_norm(cfg, lp["ln1"], x)
        if kind != "self":  # the layer's views of the stacked SSM cache
            m, _ = ssm_mod.ssm_decode_step(
                cfg, lp["ssm"], h, {k: v[i] for k, v in cache["ssm"].items()})
        if kind == "ssm":
            x = x + m
            continue
        layer_cache = {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}
        a, _ = attn_mod.self_attention(cfg, lp["attn"], h, cache=layer_cache,
                                       cache_pos=pos)
        if kind == "hybrid":
            a = 0.5 * (a + m)
        x = x + a
        h2 = apply_norm(cfg, lp["ln2"], x)
        x = x + _ffn_or_moe(cfg, lp, h2)[0]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], params.get("head", {}), x)
    return logits, {**cache, "pos": pos + 1}
