"""Calibration Hessian accumulation ``X^T X`` (or ``acc + X^T X``) in fp32.

Replaces the TPU kernel ``src/repro/kernels/hessian_accum.py``
(``hessian_accum_kernel``). The CUDA kernel is ``csrc/hessian_accum.cu``;
its header says what bounds it on the card (fp32 FMA at the main path's
shapes) and what its design does about that.

``hessian_accum`` launches the kernel for a CUDA tensor and uses the
plain PyTorch version only for a tensor on the CPU. It never falls back:
a kernel that cannot launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ENTRIES = {torch.float32: "hessian_accum_f32",
            torch.bfloat16: "hessian_accum_bf16"}


def hessian_accum_plain(x: torch.Tensor, acc: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(N, D) -> (D, D) fp32 ``X^T X``; ``acc + X^T X`` when acc is given."""
    xf = x.float()
    h = xf.T @ xf
    return h if acc is None else acc + h


def hessian_accum(x: torch.Tensor, acc: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(N, D) fp32/bf16 -> (D, D) fp32 ``X^T X``, or ``acc + X^T X`` in
    one pass when ``acc`` (D, D) fp32 is given. Counts its kernel
    launches in ``hessian_accum.launches``."""
    if x.device.type == "cpu":
        return hessian_accum_plain(x, acc)
    if x.device.type != "cuda":
        raise ValueError(f"hessian_accum: unsupported device {x.device}")
    if x.ndim != 2 or x.dtype not in _ENTRIES or not x.is_contiguous():
        raise ValueError("hessian_accum: x must be a contiguous (N, D) fp32 "
                         f"or bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    if acc is not None and (acc.device != x.device
                            or acc.dtype != torch.float32
                            or tuple(acc.shape) != (d, d)
                            or not acc.is_contiguous()):
        raise ValueError("hessian_accum: acc must be a contiguous (D, D) "
                         "fp32 tensor on x's device")
    out = torch.empty((d, d), dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    lib = build.load("hessian_accum", {e: _SIGNATURE for e in _ENTRIES.values()})
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRIES[x.dtype])(
        x.data_ptr(), acc.data_ptr() if acc is not None else None,
        out.data_ptr(), n, d, stream)
    build.check(err, "hessian_accum")
    hessian_accum.launches += 1
    return out


hessian_accum.launches = 0
