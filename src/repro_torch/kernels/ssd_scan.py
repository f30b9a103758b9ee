"""The Mamba-2 SSD scan: the intra-chunk pass as a kernel, and the chunked
scan around it.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_intra_chunk_kernel``, body ``_ssd_kernel``), whose wrapper is
``kernels/ops.py`` ``ssd_chunked_kernel`` (``_ssd_chunked_impl``) and
whose oracle is ``kernels/ref.py`` ``ssd_ref``. The CUDA kernel is
``csrc/ssd_scan.cu``. Per (batch, chunk) and head it computes the scores
``C B^T``, the causal decay ``exp(segsum(dt A))``, ``y_diag`` and the
chunk's state. On the card the operations bound it (8.3 GFLOP against
257 MB at Mamba-2 2.7B's calibration shape); the kernel runs fp32 FMA on
the CUDA cores, computes each query tile's scores once and shares them
among 8 heads, and keeps the Q x Q score and decay tiles out of device
memory (its header has the reckoning).

``ssd_intra_chunk`` launches the kernel for CUDA tensors and uses the
plain PyTorch version only for tensors on the CPU. It never falls back:
inputs the kernel does not take, or a kernel that cannot launch, raise.

``ssd_chunked`` is the port of ``_ssd_chunked_impl`` with the model
twin's inputs (``models/ssm.py`` ``ssd_chunked``): it pads to whole
chunks (padded steps carry ``dt = 0`` and leave the state untouched),
forms the in-chunk cumulative sum and ``xdt`` as the model twin does
(``x * dt`` in x's type), runs the intra-chunk pass, scans the chunk
states from ``initial_state`` (which the reference's Pallas wrapper
drops) and adds the ``y_off`` term.

bf16: the model twin computes the scores as a bf16 product, the kernel
in fp32 from the bf16 B and C; the plain version follows the model twin,
so kernel and plain version differ there by the scores' rounding. In
fp32 they compute the same function.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 6 + [_I] * 5 + [_P]
_ENTRIES = {torch.float32: "ssd_intra_chunk_f32",
            torch.bfloat16: "ssd_intra_chunk_bf16"}


def ssd_intra_chunk_plain(xdt, dacs, B, C) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The twin of ``_ssd_kernel``: xdt (b, nc, q, h, p) fp32, dacs
    (b, nc, q, h) fp32, B/C (b, nc, q, n) -> (y_diag (b, nc, q, h, p),
    states (b, nc, h, p, n)) fp32. The scores are a product in B and C's
    type, as the model twin forms them."""
    q = xdt.shape[2]
    scores = torch.einsum("bcqn,bckn->bcqk", C, B).float()
    diff = dacs[:, :, :, None, :] - dacs[:, :, None, :, :]  # (b,nc,q,k,h)
    tril = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], diff, NEG_INF))
    y = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, L, xdt)
    decay_end = torch.exp(dacs[:, :, -1:, :] - dacs)        # (b,nc,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", B.float(), decay_end,
                          xdt)
    return y, states


def _check(xdt, dacs, B, C):
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: xdt must be a CUDA or CPU "
                         f"tensor, got {xdt.device}")
    if xdt.ndim != 5:
        raise ValueError(f"ssd_intra_chunk: xdt must be (b, nc, q, h, p), "
                         f"got {tuple(xdt.shape)}")
    b, nc, q, h, p = xdt.shape
    if xdt.dtype != torch.float32 or dacs.dtype != torch.float32:
        raise ValueError(f"ssd_intra_chunk: xdt and dacs must be float32, "
                         f"got {xdt.dtype} and {dacs.dtype}")
    if dacs.shape != (b, nc, q, h):
        raise ValueError(f"ssd_intra_chunk: dacs must be {(b, nc, q, h)}, "
                         f"got {tuple(dacs.shape)}")
    if B.ndim != 4 or B.shape[:3] != (b, nc, q) or C.shape != B.shape:
        raise ValueError(f"ssd_intra_chunk: B and C must be ({b}, {nc}, "
                         f"{q}, n), got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    if B.dtype not in _ENTRIES or C.dtype != B.dtype:
        raise ValueError(f"ssd_intra_chunk: B and C must both be float32 "
                         f"or bfloat16, got {B.dtype} and {C.dtype}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_intra_chunk: the head dim must be one of "
                         f"{HEAD_DIMS}, got {p}")
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(f"ssd_intra_chunk: the chunk must hold 1 to "
                         f"{MAX_CHUNK} steps (its score rows live in shared "
                         f"memory), got {q}")
    if b * nc >= 2 ** 31 or B.shape[3] == 0:
        raise ValueError(f"ssd_intra_chunk: b * nc must be below 2**31 and "
                         f"the state size positive, got {b * nc} and "
                         f"{B.shape[3]}")
    for name, t in (("xdt", xdt), ("dacs", dacs), ("B", B), ("C", C)):
        if t.device != xdt.device:
            raise ValueError(f"ssd_intra_chunk: {name} must be on "
                             f"{xdt.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk: {name} must be contiguous "
                             "(row-major)")


def ssd_intra_chunk(xdt, dacs, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk pass (see ``ssd_intra_chunk_plain`` for shapes).
    Counts its kernel launches in ``ssd_intra_chunk.launches``."""
    if xdt.device.type == "cpu":
        return ssd_intra_chunk_plain(xdt, dacs, B, C)
    _check(xdt, dacs, B, C)
    b, nc, q, h, p = xdt.shape
    n = B.shape[3]
    y = torch.empty_like(xdt)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=xdt.device)
    if xdt.numel() == 0:
        return y, states
    lib = build.load("ssd_scan", {e: _SIGNATURE for e in _ENTRIES.values()})
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = getattr(lib, _ENTRIES[B.dtype])(
        xdt.data_ptr(), dacs.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), b * nc, q, h, p, n, stream)
    build.check(err, "ssd_intra_chunk")
    ssd_intra_chunk.launches += 1
    return y, states


ssd_intra_chunk.launches = 0


def intra_chunk_inputs(x, dt, A, B, C, chunk: int):
    """The intra-chunk pass's inputs (xdt, dacs, B, C) of a chunked scan
    (shapes as in ``ssd_chunked``), padded to whole chunks."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    dtb = dt.reshape(b, nc, chunk, h).float()
    dacs = torch.cumsum(dtb * A, dim=2).contiguous()        # (b,nc,q,h)
    xdt = (x.reshape(b, nc, chunk, h, p) * dtb[..., None].to(x.dtype))
    return (xdt.float().contiguous(), dacs,
            B.reshape(b, nc, chunk, n).contiguous(),
            C.reshape(b, nc, chunk, n).contiguous())


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x (b, s, h, p), dt (b, s, h) (softplus'ed), A (h,),
    B/C (b, s, n) -> (y (b, s, h, p) in x's type, final_state
    (b, h, p, n) fp32). The intra-chunk pass is ``ssd_intra_chunk``: the
    kernel for CUDA tensors, its plain version on the CPU."""
    b, s, h, p = x.shape
    xdt, dacs, Bb, Cb = intra_chunk_inputs(x, dt, A, B, C, chunk)
    nc, n = xdt.shape[1], Bb.shape[-1]
    y_diag, states = ssd_intra_chunk(xdt, dacs, Bb, Cb)

    # inter-chunk recurrence, one chunk at a time
    chunk_decay = torch.exp(dacs[:, :, -1, :])               # (b,nc,h)
    prev = (initial_state.float() if initial_state is not None
            else torch.zeros((b, h, p, n), dtype=torch.float32,
                             device=x.device))
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev_states, dim=1)            # (b,nc,h,p,n)

    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cb.float(), prev_states,
                         torch.exp(dacs))
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), prev
