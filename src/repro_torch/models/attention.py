"""Self-attention: grouped-head (GQA/MHA) attention with causal and
sliding-window masks and RoPE, dense and flash implementations for a
full sequence, single-token decode against a KV cache, and the ``wo_in``
capture that feeds the attention unit's Hessian; and cross-attention
against an encoder's precomputed keys and values (always dense, as in
the reference), its output gated by ``tanh(gate)``.

The flash path (``flash_attention_lax`` / ``flash_attention_chunked``)
goes through the flash-attention kernel's wrapper: the hand-written
kernel for a CUDA tensor, its plain version on the CPU. Decode attention
against the cache stays plain PyTorch, as the reference computes it
outside any kernel.

Layouts follow the JAX package: activations (B, S, D), heads
(B, S, H, Dh), weights ``y = x @ W``. Unlike the reference, decode
writes the new key/value rows into the cache tensors in place (a cache
is consumed by the step that updates it).
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import flash_attention
from .layers import apply_rope, dense_init

NEG_INF = -1e30


def attention_init(cfg, generator: torch.Generator, nlayers: int,
                   cross: bool = False):
    """Stacked projections of ``nlayers`` attention modules; a
    cross-attention module (``cross``) also gets the ``gate`` leaf (L,),
    zeros, whose tanh scales its output."""
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
    if cross:
        p["gate"] = torch.zeros(pfx)
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


def _grouped(q, hkv: int):
    """(B,S,HQ,D) -> (B,S,HKV,G,D)."""
    b, s, hq, dh = q.shape
    return q.reshape(b, s, hkv, hq // hkv, dh)


def dense_attention(q, k, v, *, causal: bool, window: int = 0):
    """Grouped-head dense attention. q: (B,Sq,HQ,D), k/v: (B,Sk,HKV,D)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = _grouped(q, hkv)
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


def flash_attention_lax(q, k, v, *, causal: bool, window: int = 0,
                        q_offset: int = 0):
    """Online-softmax attention that never materialises the (Sq, Sk) score
    matrix in device memory: one launch of the flash-attention kernel
    (its plain version on the CPU). Query row i sits at key position
    ``q_offset + i``."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, q_offset=q_offset)


def flash_attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                            max_chunks: int = 16, chunk_target: int = 2048):
    """Query-chunked flash, as the reference's: a loop over query chunks,
    each against only its causal/window key prefix (which halves causal
    work and bounds a chunk's working set), one flash launch per chunk
    with its ``q_offset``."""
    b, sq, hq, dh = q.shape
    nq = max(1, min(max_chunks, -(-sq // chunk_target)))
    bq = -(-sq // nq)
    outs = []
    for i in range(nq):
        lo = i * bq
        hi = min(sq, (i + 1) * bq)
        if lo >= sq:
            break
        k_hi = hi if causal else k.shape[1]
        k_lo = max(0, lo - window) if window else 0
        outs.append(flash_attention_lax(
            q[:, lo:hi], k[:, k_lo:k_hi], v[:, k_lo:k_hi], causal=causal,
            window=window, q_offset=lo - k_lo))
    return torch.cat(outs, dim=1)


def _select_impl(cfg, sq: int, sk: int) -> str:
    """The reference's choice: ``auto`` is flash only past 2048 tokens on
    both sides; only ``flash_lax`` names the flash path, and every other
    value (``flash_pallas`` included) runs dense attention."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash_lax" if (sq > 2048 and sk > 2048) else "dense"
    return impl


def self_attention(cfg, p, x, *, cache=None, cache_pos=None, capture=None):
    """Self-attention for a full sequence (``cache=None``) or one decode
    token against a cache. Returns ``(out, new_cache)``; for a full
    sequence ``new_cache`` is ``dict(k=, v=)`` of this call's keys (after
    RoPE) and values, (B,S,HKV,D), which a prefill stores as its cache.

    cache: ``dict(k=(B,Sc,HKV,D), v=...)``, a ring buffer for sliding
    windows; updated in place. cache_pos: the current token's absolute
    position, a 0-d integer tensor (a lockstep batch) or a (B,) vector
    (per-slot positions of the serving engine: each slot writes its own
    cache row and masks its own prefix). Writes the out-projection input
    to ``capture["wo_in"]`` when a capture dict is given.
    """
    b, sq, _ = x.shape
    causal = cfg.causal
    window = cfg.window_size if cfg.attention == "sliding_window" else 0
    q, k, v = _project_qkv(cfg, p, x)

    if cache is None:
        if cfg.pos_emb == "rope":
            pos = torch.arange(sq, device=x.device)[None, :]
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if _select_impl(cfg, sq, sq) == "flash_lax":
            out = flash_attention_chunked(q, k, v, causal=causal,
                                          window=window)
        else:
            out = dense_attention(q, k, v, causal=causal, window=window)
        new_cache = {"k": k, "v": v}
    else:
        # single-token decode: sq == 1
        ck, cv = cache["k"], cache["v"]
        sc = ck.shape[1]
        vec = cache_pos.ndim == 1  # per-slot positions (serving engine)
        posb = cache_pos[:, None] if vec else cache_pos.reshape(1, 1)
        if cfg.pos_emb == "rope":
            q = apply_rope(q, posb.expand(b, 1), cfg.rope_theta)
            k = apply_rope(k, posb.expand(b, 1), cfg.rope_theta)
        slot = cache_pos % sc if window else cache_pos.clamp(max=sc - 1)
        if vec:
            rows = torch.arange(b, device=x.device)
            ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
            cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
        else:
            ck.index_copy_(1, slot.reshape(1), k.to(ck.dtype))
            cv.index_copy_(1, slot.reshape(1), v.to(cv.dtype))
        # positions of the cached entries, per slot (B|1, Sc)
        idx = torch.arange(sc, device=x.device)[None, :]
        if window:
            # ring buffer: entry i holds the position p with p % sc == i,
            # p in (cache_pos - sc, cache_pos]
            kpos = posb - (posb - idx) % sc
        else:
            kpos = idx.expand(posb.shape[0], sc)
        valid = (kpos <= posb) & (kpos >= 0)  # >= 0: unwritten ring slots
        if window:
            valid &= kpos > posb - window
        qg = _grouped(q, cfg.num_kv_heads)
        scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck) * scale
        logits = torch.where(valid[:, None, None, None, :], logits.float(),
                             NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv)
        out = out.reshape(b, sq, cfg.num_heads, cfg.resolved_head_dim)
        new_cache = {"k": ck, "v": cv}

    flat = out.reshape(b, sq, -1)
    if capture is not None:
        capture["wo_in"] = flat
    return flat @ p["wo"].to(x.dtype), new_cache


def cross_attention(cfg, p, x, kv, *, capture=None):
    """Cross-attention of x (B, S, d) against precomputed encoder keys and
    values ``kv = dict(k=, v=)`` of (B, T, HKV, D) (``cross_kv``; shared
    by train, prefill and decode): non-causal dense attention, the
    ``wo_in`` capture, and the output scaled by ``tanh(gate)``."""
    b, sq, _ = x.shape
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = q.reshape(b, sq, cfg.num_heads, cfg.resolved_head_dim)
    out = dense_attention(q, kv["k"], kv["v"], causal=False)
    flat = out.reshape(b, sq, -1)
    if capture is not None:
        capture["wo_in"] = flat
    y = flat @ p["wo"].to(dt)
    if "gate" in p:
        y = torch.tanh(p["gate"].float()).to(dt) * y
    return y


def cross_kv(cfg, p, kv_x):
    """Cross-attention keys and values from encoder states kv_x (B, T, d):
    ``dict(k=, v=)`` of (B, T, HKV, D) in kv_x's dtype."""
    dt = kv_x.dtype
    k = kv_x @ p["wk"].to(dt)
    v = kv_x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, t, _ = k.shape
    shape = (b, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": k.reshape(shape), "v": v.reshape(shape)}


def init_kv_cache(cfg, batch: int, seq_len: int, nlayers: int, dtype,
                  device) -> dict:
    """The stacked self-attention KV cache (a ring buffer for sliding
    windows), zeros on ``device``."""
    window = cfg.window_size if cfg.attention == "sliding_window" else 0
    sc = min(seq_len, window) if window else seq_len
    shape = (nlayers, batch, sc, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
