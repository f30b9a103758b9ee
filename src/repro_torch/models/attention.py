"""Self-attention for train/prefill (no KV cache): grouped-head dense
attention with causal and sliding-window masks, RoPE, and the ``wo_in``
capture that feeds the attention unit's Hessian.

Layouts follow the JAX package: activations (B, S, D), heads
(B, S, H, Dh), weights ``y = x @ W``.
"""
from __future__ import annotations

import math

import torch

from .layers import apply_rope, dense_init

NEG_INF = -1e30


def attention_init(cfg, generator: torch.Generator, nlayers: int):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    pfx = (nlayers,)
    p = {
        "wq": dense_init(pfx + (d, hq * dh), generator),
        "wk": dense_init(pfx + (d, hkv * dh), generator),
        "wv": dense_init(pfx + (d, hkv * dh), generator),
        "wo": dense_init(pfx + (hq * dh, d), generator),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(pfx + (hq * dh,))
        p["bk"] = torch.zeros(pfx + (hkv * dh,))
        p["bv"] = torch.zeros(pfx + (hkv * dh,))
    return p


def _project_qkv(cfg, p, x):
    dt = x.dtype
    dh = cfg.resolved_head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(*q.shape[:-1], cfg.num_heads, dh)
    k = k.reshape(*k.shape[:-1], cfg.num_kv_heads, dh)
    v = v.reshape(*v.shape[:-1], cfg.num_kv_heads, dh)
    return q, k, v


def dense_attention(q, k, v, *, causal: bool, window: int = 0):
    """Grouped-head dense attention. q: (B,Sq,HQ,D), k/v: (B,Sk,HKV,D)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(dh))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits.float(), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, dh)


def self_attention(cfg, p, x, *, capture=None):
    """Full-sequence self-attention. Writes the out-projection input to
    ``capture["wo_in"]`` when a capture dict is given."""
    b, sq, _ = x.shape
    window = cfg.window_size if cfg.attention == "sliding_window" else 0
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.pos_emb == "rope":
        pos = torch.arange(sq, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = dense_attention(q, k, v, causal=cfg.causal, window=window)
    flat = out.reshape(b, sq, -1)
    if capture is not None:
        capture["wo_in"] = flat
    return flat @ p["wo"].to(x.dtype)
