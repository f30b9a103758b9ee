"""Heterogeneous pruned-model execution.

After a ZipLM shrink, layers have different head counts and FFN widths
(and some modules are gone), so the stacked per-layer leaves no longer
apply. This module runs per-layer parameter dicts in a Python loop over
the same primitive ops: this is where the structural speedup shows up
(smaller matmuls, skipped modules). It runs the attention, FFN, MoE and
SSD branches (an SSD layer through ``models.ssm.ssm_apply`` at its pruned
width, an MoE layer through ``_moe_forward``), and a hybrid layer's
attention and SSD heads side by side, averaged as the reference averages
them. The decode runtime covers attention + FFN/MoE decoders, as the
reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from . import attention as attn_mod
from .ffn import ffn_apply
from .layers import apply_norm, compute_dtype, embed_tokens, unembed
from .moe import route
from .ssm import ssm_apply
from .transformer import check_supported, init_cache


def refuse_cross_attention(cfg, what: str) -> None:
    """Raise for a config with cross-attention: a shrunk model keeps the
    self layers' attention and FFN only, so it would run without an
    encoder/decoder's encoder and cross-attention, or without a grouped
    cross stack's cross layers (``cross``) and ``frontend_proj`` (the
    reference's shrunk model drops them and its ``forward_pruned``
    ignores the frames)."""
    if cfg.encoder_decoder:
        raise NotImplementedError(
            f"{what}: {cfg.name} is an encoder/decoder model, and the "
            "pruned runtime has no encoder and no cross-attention; a "
            "shrunk model would silently lose both (prune it with "
            "oneshot_prune and use the stitched params)")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{what}: {cfg.name} has a cross-attention layer after every "
            f"{cfg.cross_attn_every} self layers, and the pruned runtime "
            "has no cross-attention; a shrunk model would silently lose "
            "its cross layers (params 'cross' and 'frontend_proj') and "
            "ignore the frames (prune it with oneshot_prune and use the "
            "stitched params)")


@dataclass
class PrunedLayer:
    kv_groups: int = 0        # attention KV groups remaining (0 = dropped)
    d_ff: int = 0             # FFN intermediate remaining (0 = dropped)
    ssm_heads: int = 0        # SSD heads remaining (0 = dropped)
    expert_ff: List[int] = field(default_factory=list)  # per expert, 0 = dropped
    params: Dict[str, Any] = field(default_factory=dict)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


@dataclass
class PrunedModel:
    cfg: Any                  # original ModelConfig
    layers: List[PrunedLayer]
    globals_: Dict[str, Any]  # embed / final_norm / head

    def num_params(self) -> int:
        leaves = _leaves([l.params for l in self.layers]) \
            + _leaves(self.globals_)
        return int(sum(t.numel() for t in leaves))

    def encoder_params(self) -> int:
        """Transformer-stack params only (the paper reports 'encoder
        size')."""
        return int(sum(t.numel() for l in self.layers
                       for t in _leaves(l.params)))


def _vcfg(cfg, lcfg: PrunedLayer):
    """Per-layer view config: head counts shrunk to this layer's survivors.
    The head dim is pinned: a config that leaves ``head_dim`` 0 (GPT-2
    small) would otherwise derive it anew from the shrunk head count."""
    return cfg.replace(num_heads=lcfg.kv_groups * cfg.q_per_kv,
                       num_kv_heads=lcfg.kv_groups,
                       head_dim=cfg.resolved_head_dim)


def _has_attn(lcfg: PrunedLayer) -> bool:
    return lcfg.kv_groups > 0 and "attn" in lcfg.params


def _moe_forward(cfg, lp, x):
    """A pruned MoE layer, its experts of different widths. A fully
    dropped expert keeps its router column and a ``None`` compute slot,
    so the top-k over all E columns (and the normalisation of the chosen
    weights) is the masked model's: a dead expert can win a slot and
    absorb routing weight, it only contributes nothing. Each live expert
    runs on every token (a dense gather, the reference's), weighted by
    its routing weight; no token is dropped, unlike the dense model's
    capacity dispatch."""
    dt = x.dtype
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    k = min(cfg.num_experts_per_tok, lp["router"].shape[-1])
    _, topw, topi = route(lp["router"], xf, k)
    out = torch.zeros_like(xf)
    for e, ep in enumerate(lp["experts"]):
        if ep is None:  # dropped: routable, no contribution, no FLOPs
            continue
        w_e = torch.where(topi == e, topw, 0.0).sum(-1).to(dt)  # (t,)
        h = F.silu(xf @ ep["wg"].to(dt)) * (xf @ ep["wu"].to(dt))
        out = out + w_e[:, None] * (h @ ep["wd"].to(dt))
    return out.reshape(b, s, d)


def _ffn_block(cfg, lcfg: PrunedLayer, x):
    """The layer's FFN or MoE residual branch, if any of it is left. A
    GELU FFN with every row removed still adds its output bias ``bd``,
    as the masked model does (its zeroed ``wd`` rows leave ``y = bd``)."""
    if lcfg.expert_ff:
        h2 = apply_norm(cfg, lcfg.params["ln2"], x)
        x = x + _moe_forward(cfg, lcfg.params["moe"], h2)
    elif lcfg.d_ff > 0 and "ffn" in lcfg.params:
        h2 = apply_norm(cfg, lcfg.params["ln2"], x)
        x = x + ffn_apply(cfg, lcfg.params["ffn"], h2)
    elif "ffn" in lcfg.params:
        x = x + lcfg.params["ffn"]["bd"].to(x.dtype)
    return x


def _head(pm: "PrunedModel", x):
    x = apply_norm(pm.cfg, pm.globals_["final_norm"], x)
    return unembed(pm.cfg, pm.globals_["embed"], pm.globals_.get("head", {}),
                   x)


def forward_pruned(pm: PrunedModel, tokens) -> torch.Tensor:
    """Forward over heterogeneous pruned layers -> fp32 logits (B,S,V).
    Both mixers of a layer read one normed input. In a hybrid layer the
    residual takes ``0.5 * (attn + ssm)`` with both branches live and
    ``0.5 * live`` with one dropped, as the dense block averages them (the
    reference's ``forward_pruned``); raises for a family the port does
    not run, and for a model with cross-attention."""
    cfg = pm.cfg
    refuse_cross_attention(cfg, "forward_pruned")
    check_supported(cfg)
    tokens = tokens.to(pm.globals_["embed"]["table"].device)
    x = embed_tokens(cfg, pm.globals_["embed"], tokens)
    for lcfg in pm.layers:
        lp = lcfg.params
        mixed = []
        if _has_attn(lcfg):
            h = apply_norm(cfg, lp["ln1"], x)
            mixed.append(attn_mod.self_attention(_vcfg(cfg, lcfg),
                                                 lp["attn"], h)[0])
        if lcfg.ssm_heads > 0 and "ssm" in lp:
            h = apply_norm(cfg, lp["ln1"], x)
            mixed.append(ssm_apply(cfg, lp["ssm"], h))
        if mixed:
            y = mixed[0] if len(mixed) == 1 else mixed[0] + mixed[1]
            x = x + (0.5 * y if cfg.hybrid else y)
        x = _ffn_block(cfg, lcfg, x)
    return _head(pm, x)


# ----------------------------------------------------------------------
# pruned decode runtime (serving)
# ----------------------------------------------------------------------

def _check_decodable(cfg):
    if cfg.family == "ssm" or cfg.hybrid or cfg.encoder_decoder \
            or cfg.cross_attn_every:
        raise NotImplementedError(
            "pruned decode runtime covers attention+FFN/MoE decoders only; "
            f"family={cfg.family!r} hybrid={cfg.hybrid} "
            f"enc-dec={cfg.encoder_decoder} needs the dense runtime")


def _kv_heads(pm: PrunedModel) -> List[int]:
    return [l.kv_groups if _has_attn(l) else 0 for l in pm.layers]


def init_cache_pruned(pm: PrunedModel, batch: int, max_len: int, dtype=None,
                      *, per_slot: bool = False):
    """Per-layer pruned KV cache, on the model's device: bytes follow the
    shrunk structure. A dropped attention module gets ``None``, a kept
    one a (B, max_len, kv_groups, head_dim) buffer."""
    _check_decodable(pm.cfg)
    return init_cache(pm.cfg, batch, max_len, dtype, kv_heads=_kv_heads(pm),
                      per_slot=per_slot,
                      device=pm.globals_["embed"]["table"].device)


def kv_cache_bytes_per_layer(pm: PrunedModel, batch: int, max_len: int,
                             dtype=None) -> List[int]:
    """Per-layer bytes of ``init_cache_pruned``'s k/v buffers: 0 for a
    layer whose attention module is pruned away or that is dropped."""
    itemsize = torch.empty((), dtype=dtype or compute_dtype(pm.cfg)
                           ).element_size()
    dh = pm.cfg.resolved_head_dim
    return [2 * batch * max_len * h * dh * itemsize for h in _kv_heads(pm)]


def kv_cache_bytes(pm: PrunedModel, batch: int, max_len: int,
                   dtype=None) -> int:
    """Bytes of ``init_cache_pruned``'s k/v buffers."""
    return sum(kv_cache_bytes_per_layer(pm, batch, max_len, dtype))


def prefill_pruned(pm: PrunedModel, tokens, max_len: int, *,
                   full_logits: bool = False):
    """Pruned prefill: a full forward that also fills the per-layer KV
    cache (the counterpart of ``model.serve_prefill``). Returns
    (last-position logits (B,1,V), or every position's (B,S,V) with
    ``full_logits`` for bucket-padded serving, and the cache) with a 0-d
    ``cache["pos"]``."""
    cfg = pm.cfg
    _check_decodable(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise RuntimeError(f"prompt_len={s} exceeds cache max_len={max_len}")
    cache = init_cache_pruned(pm, b, max_len)
    tokens = tokens.to(pm.globals_["embed"]["table"].device)
    x = embed_tokens(cfg, pm.globals_["embed"], tokens)
    for i, lcfg in enumerate(pm.layers):
        if _has_attn(lcfg):
            vcfg = _vcfg(cfg, lcfg)
            lp = lcfg.params
            h = apply_norm(cfg, lp["ln1"], x)
            a, kv = attn_mod.self_attention(vcfg, lp["attn"], h)
            buf = cache["attn"][i]
            buf["k"][:, :s] = kv["k"]
            buf["v"][:, :s] = kv["v"]
            x = x + a
        x = _ffn_block(cfg, lcfg, x)
    logits = _head(pm, x)
    cache["pos"].fill_(s)
    return (logits if full_logits else logits[:, -1:]), cache


def decode_step_pruned(pm: PrunedModel, cache, tokens):
    """One-token decode over heterogeneous pruned layers.

    ``cache["pos"]`` is 0-d (lockstep) or a (B,) per-slot vector, the
    contract of ``transformer.decode_step``; the k/v buffers are updated
    in place. Returns (logits (B,1,V), new_cache)."""
    cfg = pm.cfg
    pos = cache["pos"]
    positions = None
    if cfg.pos_emb == "learned":
        positions = pos[:, None] if pos.ndim == 1 else pos[None]
    tokens = tokens.to(pm.globals_["embed"]["table"].device)
    x = embed_tokens(cfg, pm.globals_["embed"], tokens, positions=positions)
    for i, lcfg in enumerate(pm.layers):
        if _has_attn(lcfg):
            h = apply_norm(cfg, lcfg.params["ln1"], x)
            a, _ = attn_mod.self_attention(
                _vcfg(cfg, lcfg), lcfg.params["attn"], h,
                cache=cache["attn"][i], cache_pos=pos)
            x = x + a
        x = _ffn_block(cfg, lcfg, x)
    return _head(pm, x), {"pos": pos + 1, "attn": cache["attn"]}
