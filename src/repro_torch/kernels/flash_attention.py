"""Forward online-softmax attention with causal and sliding-window masks,
a ``q_offset`` (queries aligned to the end of the keys) and GQA.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_kernel``), whose wrapper is ``kernels/ops.py``
``flash_attention`` and whose oracle is ``kernels/ref.py``
``attention_ref``. The CUDA source is ``csrc/flash_attention.cu``, with
one kernel per type: bf16 on the tensor cores, fp32 on the CUDA cores in
exact fp32. Its header says what bounds them on the card and what their
designs do about that.

``flash_attention`` takes the reference wrapper's layout, q (B, Sq, HQ, D)
and k/v (B, Sk, HKV, D), and returns (B, Sq, HQ, D) in q's type. It
launches the kernel for CUDA tensors and uses the plain PyTorch version
only for tensors on the CPU. It never falls back: inputs the kernel does
not take, or a kernel that cannot launch, raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P] + [_I] * 10 + [ctypes.c_float, _P]
_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """Dense attention with GQA repeated (the twin of the reference's
    ``ref.attention_ref`` behind ``ops._flash_attention_ref``); query row
    i sits at key position ``q_offset + i``, by default ``Sk - Sq``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = sk - sq
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def _every_row_attends(sq: int, sk: int, q_offset: int, causal: bool,
                       window: int) -> bool:
    """True iff every query row has at least one key to attend to. The
    count of a row's keys is concave in its position, so the first and
    the last row decide."""
    def keys(p):
        hi = min(sk - 1, p) if causal else sk - 1
        lo = max(0, p - window + 1) if window else 0
        return hi - lo + 1
    return keys(q_offset) > 0 and keys(q_offset + sq - 1) > 0


def _check(q, k, v, window):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q must be a CUDA or CPU tensor, "
                         f"got {q.device}")
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be (B, Sq, HQ, D), got "
                         f"{tuple(q.shape)}")
    b, _, hq, d = q.shape
    if q.dtype not in _ENTRIES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: q's head dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    # the fp32 kernel's grid has one row per (batch, query head), at most
    # 65535; the bf16 kernel's grid is 1-D, and its launch refuses more
    # than 2^31 - 1 blocks (query tiles x B x HQ)
    if q.dtype == torch.float32 and b * hq > 65535:
        raise ValueError(f"flash_attention: an fp32 q's B * HQ must be at "
                         f"most 65535, got {b * hq}")
    for name, t in (("k", k), ("v", v)):
        if t.ndim != 4 or t.shape[0] != b or t.shape[3] != d:
            raise ValueError(f"flash_attention: {name} must be (B={b}, Sk, "
                             f"HKV, D={d}), got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if v.shape != k.shape:
        raise ValueError(f"flash_attention: v must have k's shape "
                         f"{tuple(k.shape)}, got {tuple(v.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"flash_attention: k's {k.shape[2]} heads must "
                         f"divide q's {hq}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: k must hold at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "(row-major)")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: a bf16 {name} must start on "
                             "a 16-byte boundary (the kernel copies 16 "
                             "bytes at a time)")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, HQ, D), k/v (B, Sk, HKV, D), fp32 or bf16, D in
    ``HEAD_DIMS`` -> (B, Sq, HQ, D) in q's type. Counts its kernel
    launches in ``flash_attention.launches``. The kernel has no backward:
    a launch with grad mode on and an input that requires grad raises (the
    plain version on the CPU stays differentiable)."""
    build.dispatch()
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    build.check_no_grad("flash_attention", q, k, v)
    _check(q, k, v, window)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q_offset = sk - sq if q_offset is None else int(q_offset)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    band = _every_row_attends(sq, sk, q_offset, causal, window)
    lib = build.load("flash_attention",
                     {e: _SIGNATURE for e in _ENTRIES.values()})
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, _ENTRIES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        hq, hkv, d, q_offset, int(causal), int(window), int(band),
        1.0 / math.sqrt(d), stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
