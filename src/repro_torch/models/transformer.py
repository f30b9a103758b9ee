"""Transformer stack: init, full-sequence forward (train / prefill) and
single-token decode for dense self-attention models (GPT-2/BERT/llama-style
blocks), mixture-of-experts models (the FFN of every block a
``models.moe`` layer), Mamba-2 (SSD) stacks, Hymba-style hybrid
stacks (attention and SSD heads side by side on the block's normed
input, their outputs averaged, then the FFN) and Whisper-style
encoder/decoder models (a non-causal encoder over the audio stub's frame
embeddings; each decoder block self-attention, then cross-attention to
the encoder's output, then the FFN), and Llama-3.2-Vision-style stacks
(``cross_attn_every``: the self layers in groups of ``cross_attn_every``,
each group followed by one gated cross-attention module over the vision
stub's patch embeddings).

Per-layer weights are stacked along a leading layer axis, as in the JAX
package; the forward and decode are Python loops over layers where the
reference scans (over groups, then over each group's layers, for the
grouped cross stacks).
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
    every = cfg.cross_attn_every
    unsupported = {
        "num_experts in the ssm family": cfg.num_experts and ssm,
        "hybrid in the ssm family": cfg.hybrid and ssm,
        "ssm_state outside the ssm family and hybrid blocks":
            cfg.ssm_state and not (ssm or cfg.hybrid),
        "family='ssm' without ssm_state": ssm and not cfg.ssm_state,
        "hybrid without ssm_state": cfg.hybrid and not cfg.ssm_state,
        "encoder_decoder without the audio_stub frontend":
            cfg.encoder_decoder and cfg.frontend != "audio_stub",
        "encoder_decoder with experts or SSD heads":
            cfg.encoder_decoder and bool(cfg.num_experts or cfg.ssm_state),
        "cross_attn_every in the ssm family": every and ssm,
        "cross_attn_every with hybrid": every and cfg.hybrid,
        "cross_attn_every with encoder_decoder":
            every and cfg.encoder_decoder,
        "num_layers not a multiple of cross_attn_every":
            every and cfg.num_layers % every,
        "cross_attn_every without the vision_stub frontend":
            every and cfg.frontend != "vision_stub",
        "vision_stub without cross_attn_every":
            cfg.frontend == "vision_stub" and not every,
        "audio_stub without encoder_decoder":
            cfg.frontend == "audio_stub" and not cfg.encoder_decoder,
        f"the frontend {cfg.frontend!r}":
            cfg.frontend not in ("none", "audio_stub", "vision_stub"),
        "attention='none'": cfg.attention == "none" and not ssm,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense and MoE self-attention, "
            f"Mamba-2, hybrid attention + SSD, audio encoder/decoder and "
            f"grouped vision cross-attention stacks only (unsupported: "
            f"{', '.join(bad)})")


def block_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    return "decoder" if cfg.encoder_decoder else "self"


def cross_groups(cfg) -> int:
    """The number of grouped cross-attention modules: one after every
    ``cross_attn_every`` self layers (0 without them)."""
    every = cfg.cross_attn_every
    return cfg.num_layers // every if every else 0


def _encoder_cfg(cfg):
    """The encoder's view of an encoder/decoder config: bidirectional,
    full attention."""
    return cfg.replace(causal=False, attention="full")


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
        if kind == "decoder":
            layers["lnx"] = norm_init(cfg, L)
            layers["xattn"] = attn_mod.attention_init(cfg, g, L, cross=True)
    params: Dict[str, Any] = {
        "embed": embed,
        "layers": layers,
        "final_norm": norm_init(cfg),
        "head": ({} if cfg.tie_embeddings else
                 {"w": dense_init((cfg.vocab_size, cfg.d_model), g,
                                  in_axis=-1)}),
    }
    if kind == "decoder":
        enc, n = _encoder_cfg(cfg), cfg.num_encoder_layers
        params["enc_layers"] = {"ln1": norm_init(enc, n),
                                "attn": attn_mod.attention_init(enc, g, n),
                                "ln2": norm_init(enc, n),
                                "ffn": ffn_mod.ffn_init(enc, g, n)}
        params["enc_norm"] = norm_init(cfg)
        params["enc_pos"] = dense_init(
            (cfg.num_frontend_tokens, cfg.d_model), g, in_axis=-1)
    G = cross_groups(cfg)
    if G:  # the grouped cross-attention modules (gates 0, as drawn)
        params["cross"] = {
            "lnx": norm_init(cfg, G),
            "xattn": attn_mod.attention_init(cfg, g, G, cross=True)}
        if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            params["frontend_proj"] = dense_init(
                (cfg.frontend_dim, cfg.d_model), g)
    return tree_to(params, dev)


# ----------------------------------------------------------------------
# the parameters' layout: shapes and logical axis names
# ----------------------------------------------------------------------
# Each leaf is a (shape, spec) pair: its shape and, one per dim, the
# logical axis name that ``distributed.sharding.logical_to_pspec`` maps
# to mesh axes, as the reference's ``model_init`` returns them beside its
# params. The functions follow the reference's ``*_init`` functions leaf
# for leaf.

def _norm_layout(cfg, nlayers: int = 0):
    shape = (nlayers, cfg.d_model) if nlayers else (cfg.d_model,)
    spec = ("layers", None) if nlayers else (None,)
    out = {"scale": (shape, spec)}
    if cfg.norm == "layernorm":
        out["bias"] = (shape, spec)
    return out


def _attention_layout(cfg, nlayers: int, cross: bool = False):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    pfx, spfx = (nlayers,), ("layers",)
    out = {"wq": (pfx + (d, hq * dh), spfx + ("embed", "heads")),
           "wk": (pfx + (d, hkv * dh), spfx + ("embed", "kv")),
           "wv": (pfx + (d, hkv * dh), spfx + ("embed", "kv")),
           "wo": (pfx + (hq * dh, d), spfx + ("heads", "embed"))}
    if cfg.qkv_bias:
        out["bq"] = (pfx + (hq * dh,), spfx + ("heads",))
        out["bk"] = (pfx + (hkv * dh,), spfx + ("kv",))
        out["bv"] = (pfx + (hkv * dh,), spfx + ("kv",))
    if cross:
        out["gate"] = (pfx, spfx)
    return out


def _ffn_layout(cfg, nlayers: int):
    d, f = cfg.d_model, cfg.d_ff
    pfx, spfx = (nlayers,), ("layers",)
    if cfg.ffn_activation == "swiglu":
        return {"wg": (pfx + (d, f), spfx + ("embed", "mlp")),
                "wu": (pfx + (d, f), spfx + ("embed", "mlp")),
                "wd": (pfx + (f, d), spfx + ("mlp", "embed"))}
    return {"wi": (pfx + (d, f), spfx + ("embed", "mlp")),
            "bi": (pfx + (f,), spfx + ("mlp",)),
            "wd": (pfx + (f, d), spfx + ("mlp", "embed")),
            "bd": (pfx + (d,), spfx + ("embed",))}


def _moe_layout(cfg, nlayers: int):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pfx, spfx = (nlayers,), ("layers",)
    return {"router": (pfx + (d, e), spfx + ("embed", None)),
            "wg": (pfx + (e, d, f), spfx + ("experts", "embed",
                                               "mlp_noshard")),
            "wu": (pfx + (e, d, f), spfx + ("experts", "embed",
                                               "mlp_noshard")),
            "wd": (pfx + (e, f, d), spfx + ("experts", "mlp_noshard",
                                               "embed"))}


def _ssm_layout(cfg, nlayers: int):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, k = cfg.ssm_heads, cfg.ssm_conv
    pfx, spfx = (nlayers,), ("layers",)
    return {"in_z": (pfx + (d, di), spfx + ("embed", "ssm")),
            "in_x": (pfx + (d, di), spfx + ("embed", "ssm")),
            "in_bc": (pfx + (d, 2 * n), spfx + ("embed", None)),
            "in_dt": (pfx + (d, h), spfx + ("embed", "ssm_heads")),
            "conv_x": (pfx + (k, di), spfx + (None, "ssm")),
            "conv_x_b": (pfx + (di,), spfx + ("ssm",)),
            "conv_bc": (pfx + (k, 2 * n), spfx + (None, None)),
            "conv_bc_b": (pfx + (2 * n,), spfx + (None,)),
            "A_log": (pfx + (h,), spfx + ("ssm_heads",)),
            "D": (pfx + (h,), spfx + ("ssm_heads",)),
            "dt_bias": (pfx + (h,), spfx + ("ssm_heads",)),
            "norm": (pfx + (di,), spfx + ("ssm",)),
            "out_proj": (pfx + (di, d), spfx + ("ssm", "embed"))}


def _block_layout(cfg, nlayers: int, kind: str):
    if kind == "ssm":
        return {"ln1": _norm_layout(cfg, nlayers),
                "ssm": _ssm_layout(cfg, nlayers)}
    out = {"ln1": _norm_layout(cfg, nlayers),
           "attn": _attention_layout(cfg, nlayers),
           "ln2": _norm_layout(cfg, nlayers)}
    if cfg.num_experts:
        out["moe"] = _moe_layout(cfg, nlayers)
    else:
        out["ffn"] = _ffn_layout(cfg, nlayers)
    if kind == "hybrid":
        out["ssm"] = _ssm_layout(cfg, nlayers)
    if kind == "decoder":
        out["lnx"] = _norm_layout(cfg, nlayers)
        out["xattn"] = _attention_layout(cfg, nlayers, cross=True)
    return out


def _model_layout(cfg) -> Dict[str, Any]:
    embed = {"table": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if cfg.pos_emb == "learned":
        embed["pos"] = ((cfg.max_position, cfg.d_model), (None, "embed"))
    out: Dict[str, Any] = {
        "embed": embed,
        "layers": _block_layout(cfg, cfg.num_layers, block_kind(cfg)),
        "final_norm": _norm_layout(cfg),
        "head": ({} if cfg.tie_embeddings else
                 {"w": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}),
    }
    if cfg.encoder_decoder:
        out["enc_layers"] = _block_layout(
            _encoder_cfg(cfg), cfg.num_encoder_layers, "self")
        out["enc_norm"] = _norm_layout(cfg)
        out["enc_pos"] = ((cfg.num_frontend_tokens, cfg.d_model),
                          (None, "embed"))
    G = cross_groups(cfg)
    if G:
        out["cross"] = {"lnx": _norm_layout(cfg, G),
                        "xattn": _attention_layout(cfg, G, cross=True)}
        if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            out["frontend_proj"] = ((cfg.frontend_dim, cfg.d_model),
                                    (None, "embed"))
    return out


def _layout_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _layout_map(fn, v) for k, v in tree.items()}
    return fn(*tree)


def model_specs(cfg) -> Dict[str, Any]:
    """The logical axis names of ``model_init(cfg)``'s params: a tree of
    its structure whose leaves are tuples, one name (or None) per dim,
    the tree that the reference's ``model_init`` returns as its second
    value. ``distributed.sharding.param_shardings`` maps it onto a
    mesh."""
    return _layout_map(lambda shape, spec: spec, _model_layout(cfg))


def param_shapes(cfg) -> Dict[str, Any]:
    """The shapes of ``model_init(cfg)``'s params, without drawing them
    (a tree of tuples)."""
    return _layout_map(lambda shape, spec: tuple(shape), _model_layout(cfg))


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


def _decoder_block(cfg, lp, x, kv, *, build_cache: bool, capture: bool):
    """One encoder/decoder decoder block: self-attention, then ``lnx`` and
    cross-attention to the encoder's keys and values ``kv`` (this
    layer's ``cross_kv``), then the FFN. Returns (x, None, cache_kv,
    None, captures ``attn``/``xattn``/``ffn``)."""
    cap_a = {} if capture else None
    cap_x = {} if capture else None
    cap_f = {} if capture else None
    h = apply_norm(cfg, lp["ln1"], x)
    a, self_kv = attn_mod.self_attention(cfg, lp["attn"], h, capture=cap_a)
    x = x + a
    hx = apply_norm(cfg, lp["lnx"], x)
    x = x + attn_mod.cross_attention(cfg, lp["xattn"], hx, kv,
                                     capture=cap_x)
    h2 = apply_norm(cfg, lp["ln2"], x)
    x = x + ffn_mod.ffn_apply(cfg, lp["ffn"], h2, capture=cap_f)
    cache_kv = (self_kv["k"], self_kv["v"]) if build_cache else None
    caps = {"attn": cap_a, "xattn": cap_x, "ffn": cap_f} if capture else {}
    return x, None, cache_kv, None, caps


def encoder_forward(cfg, params, frontend_embeds):
    """The Whisper-style encoder over the frontend's frame embeddings
    (B, T, d): learned positions, ``num_encoder_layers`` bidirectional
    self-attention blocks, then ``enc_norm``. Returns (B, T, d) in the
    compute dtype."""
    enc = _encoder_cfg(cfg)
    x = frontend_embeds.to(compute_dtype(cfg))
    x = x + params["enc_pos"][None, :x.shape[1]].to(x.dtype)
    for i in range(cfg.num_encoder_layers):
        x = _self_block(enc, _layer(params["enc_layers"], i), x,
                        build_cache=False, capture=False)[0]
    return apply_norm(cfg, params["enc_norm"], x)


def frontend_kv(cfg, params, frontend_embeds):
    """Each cross group's keys and values of the frames (B, T, F): cast to
    the compute dtype, projected by ``frontend_proj`` when the config has
    one, then ``cross_kv`` per group, stacked to (G, B, T, HKV, D)."""
    fe = frontend_embeds.to(compute_dtype(cfg))
    if "frontend_proj" in params:
        fe = fe @ params["frontend_proj"].to(fe.dtype)
    xattn = params["cross"]["xattn"]
    return _stack([attn_mod.cross_kv(cfg, {k: t[g] for k, t in xattn.items()},
                                     fe)
                   for g in range(cross_groups(cfg))])


def _cross_module(cfg, params, g: int, x, kv):
    """Cross group ``g`` on the residual stream: ``x + cross_attention(
    lnx(x))`` against its frames' keys and values, ``kv``'s entry ``g``
    (``kv``: the groups' ``{k, v}`` stacked to (G, B, T, HKV, D))."""
    cp = {grp: {k: t[g] for k, t in sub.items()}
          for grp, sub in params["cross"].items()}
    hx = apply_norm(cfg, cp["lnx"], x)
    return x + attn_mod.cross_attention(cfg, cp["xattn"], hx,
                                        {k: t[g] for k, t in kv.items()})


def _stack(trees):
    """Per-layer trees (nested dicts of tensors) -> one tree of stacked
    tensors with a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def forward(cfg, params, tokens: torch.Tensor, *, frontend_embeds=None,
            mode: str = "train", capture: bool = False,
            collect_hiddens: bool = False):
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

    An encoder/decoder model takes ``frontend_embeds`` (B, T, F), runs
    the encoder over them, and also returns ``encoder_out`` (B, T, d)
    and ``cross_kv``, each decoder layer's cross-attention keys and
    values stacked to (L, B, T, HKV, D) (a prefill's decode cache keeps
    them as ``cache["cross"]``); its captures are ``attn``, ``xattn``
    and ``ffn``, of the decoder layers only.

    A grouped cross stack (``cross_attn_every``) also takes
    ``frontend_embeds`` and returns ``frontend_kv`` (G, B, T, HKV, D);
    cross group ``g`` is applied after self layer ``(g + 1) * every -
    1``. Captures, hiddens and the cache stay per self layer, and a
    group's last hidden state is read before its cross module, as the
    reference's two-level scan collects them; the cross modules'
    captures are not returned.
    """
    check_supported(cfg)
    build_cache = mode == "prefill"
    dev = params["embed"]["table"].device
    tokens = tokens.to(dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    kind = block_kind(cfg)
    out: Dict[str, Any] = {}
    if kind == "decoder":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder/decoder forward needs "
                             "frontend_embeds")
        enc_out = encoder_forward(cfg, params, frontend_embeds.to(dev))
        xattn = params["layers"]["xattn"]
        cross = _stack([attn_mod.cross_kv(
            cfg, {k: t[i] for k, t in xattn.items()}, enc_out)
            for i in range(cfg.num_layers)])
        out.update(encoder_out=enc_out, cross_kv=cross)
    every = cfg.cross_attn_every
    if every:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: a cross-attention forward needs "
                             "frontend_embeds")
        group_kv = frontend_kv(cfg, params, frontend_embeds.to(dev))
        out["frontend_kv"] = group_kv
    block = _ssm_block if kind == "ssm" else _self_block
    caps, kv_caches, ssm_caches, auxes, hiddens = [], [], [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if kind == "decoder":
            x, aux, c_kv, c_ssm, c = _decoder_block(
                cfg, lp, x, {k: t[i] for k, t in cross.items()},
                build_cache=build_cache, capture=capture)
        else:
            x, aux, c_kv, c_ssm, c = block(cfg, lp, x,
                                           build_cache=build_cache,
                                           capture=capture)
        caps.append(c)
        kv_caches.append(c_kv)
        ssm_caches.append(c_ssm)
        if aux is not None:
            auxes.append(aux)
        if collect_hiddens:
            hiddens.append(x)
        if every and (i + 1) % every == 0:  # the group's cross module
            x = _cross_module(cfg, params, i // every, x, group_kv)
    x = apply_norm(cfg, params["final_norm"], x)
    out.update(logits=unembed(cfg, params["embed"], params.get("head", {}),
                              x),
               aux=(torch.stack(auxes).mean() if auxes
                    else torch.zeros((), device=dev)))
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
    layers instead of k/v buffers; a hybrid stack's holds both. An
    encoder/decoder stack's also holds ``cross = {k, v}`` of (L, B, T,
    HKV, D), the decoder layers' cross-attention keys and values (zeros
    here; a prefill fills them); a grouped cross stack's ``cross`` is
    (G, B, T, HKV, D), one per cross group.
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
    if kind == "decoder" or cfg.cross_attn_every:
        n = cfg.num_layers if kind == "decoder" else cross_groups(cfg)
        shape = (n, batch, cfg.num_frontend_tokens,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return cache


def decode_step(cfg, params, cache, tokens):
    """One-token decode. tokens: (B, 1). Returns (logits (B,1,V) fp32,
    new_cache).

    ``cache["pos"]`` is a 0-d tensor (lockstep batch) or a (B,) vector of
    per-slot positions (continuous batching): each slot then embeds,
    RoPE-rotates, writes and masks at its own absolute position. The
    cache's k/v (or SSM state and conv) tensors are updated in place; the
    new cache holds them and ``pos + 1``. A grouped cross stack applies
    cross group ``g`` after self layer ``(g + 1) * every - 1`` against
    ``cache["cross"][g]``, as ``forward`` does.
    """
    pos = cache["pos"]
    positions = None
    if cfg.pos_emb == "learned":
        positions = pos[:, None] if pos.ndim == 1 else pos[None]
    dev = params["embed"]["table"].device
    x = embed_tokens(cfg, params["embed"], tokens.to(dev),
                     positions=positions)
    kind = block_kind(cfg)
    every = cfg.cross_attn_every
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = apply_norm(cfg, lp["ln1"], x)
        if kind in ("ssm", "hybrid"):  # the layer's views of the SSM cache
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
        if kind == "decoder":  # against the prefill's encoder keys/values
            hx = apply_norm(cfg, lp["lnx"], x)
            x = x + attn_mod.cross_attention(
                cfg, lp["xattn"], hx,
                {k: t[i] for k, t in cache["cross"].items()})
        h2 = apply_norm(cfg, lp["ln2"], x)
        x = x + _ffn_or_moe(cfg, lp, h2)[0]
        if every and (i + 1) % every == 0:
            x = _cross_module(cfg, params, i // every, x, cache["cross"])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], params.get("head", {}), x)
    return logits, {**cache, "pos": pos + 1}
