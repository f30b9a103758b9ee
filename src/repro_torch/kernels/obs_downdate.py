"""The fused structured-OBS rank-``gs`` downdate of one Algorithm-1 step.

Replaces the TPU kernel ``src/repro/kernels/obs_downdate.py``
(``obs_downdate_kernel``). Per module::

  W    <- (W    - HcolS @ KsWS)    * keep[:, None]
  Hinv <- (Hinv - HcolS @ KsHcolT) * keep[:, None] * keep[None, :]

with a leading module axis M, so one launch covers a whole module group
(where the reference ran the kernel under ``vmap``). ``d_live`` restricts
the update to the live prefix and zeroes the tail rows (and Hinv
columns), as ``kernels/ref.py::live_prefix_downdate`` does. The CUDA
kernel is ``csrc/obs_downdate.cu``; its header says what bounds it
(device memory traffic for gs == 1) and what its design does about it.

``obs_downdate`` launches the kernel for CUDA tensors, updating ``W`` and
``Hinv`` in place, and uses the plain PyTorch version only for tensors on
the CPU (which returns new tensors). Callers treat ``W`` and ``Hinv`` as
consumed and use the returned pair. It never falls back: a kernel that
cannot launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = {"obs_downdate_f32": [_P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _P]}


def obs_downdate_plain(W, Hinv, HcolS, KsWS, KsHcolT, keep,
                       d_live: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version; any number of leading module axes."""
    d_in = W.shape[-2]
    if d_live is not None and d_live < d_in:
        Wl, Hl = obs_downdate_plain(
            W[..., :d_live, :], Hinv[..., :d_live, :d_live],
            HcolS[..., :d_live, :], KsWS, KsHcolT[..., :d_live],
            keep[..., :d_live])
        tail = d_in - d_live
        return (torch.nn.functional.pad(Wl, (0, 0, 0, tail)),
                torch.nn.functional.pad(Hl, (0, tail, 0, tail)))
    k = keep.float()
    A = HcolS.float()
    if A.shape[-1] == 1:
        # rank-1: the broadcast outer product (one rounded multiply)
        dW, dH = A * KsWS.float(), A * KsHcolT.float()
    else:
        dW, dH = A @ KsWS.float(), A @ KsHcolT.float()
    W_new = (W.float() - dW) * k[..., :, None]
    Hinv_new = (Hinv.float() - dH) * k[..., :, None] * k[..., None, :]
    return W_new, Hinv_new


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def obs_downdate(W, Hinv, HcolS, KsWS, KsHcolT, keep,
                 d_live: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused downdate for M modules: W (M, d_in, d_out), Hinv
    (M, d_in, d_in), HcolS (M, d_in, gs), KsWS (M, gs, d_out), KsHcolT
    (M, gs, d_in), keep (M, d_in). Counts its kernel launches in
    ``obs_downdate.launches``."""
    build.dispatch()
    if W.device.type == "cpu":
        return obs_downdate_plain(W, Hinv, HcolS, KsWS, KsHcolT, keep, d_live)
    if W.device.type != "cuda":
        raise ValueError(f"obs_downdate: unsupported device {W.device}")
    M, d_in, d_out = W.shape
    gs = HcolS.shape[-1]
    want = {"W": (W, (M, d_in, d_out)), "Hinv": (Hinv, (M, d_in, d_in)),
            "HcolS": (HcolS, (M, d_in, gs)), "KsWS": (KsWS, (M, gs, d_out)),
            "KsHcolT": (KsHcolT, (M, gs, d_in)), "keep": (keep, (M, d_in))}
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != W.device or not t.is_contiguous()):
            raise ValueError(
                f"obs_downdate: {name} must be a contiguous fp32 {shape} "
                f"tensor on {W.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    for name in ("HcolS", "KsWS", "KsHcolT", "keep"):
        t = want[name][0]
        if _shares_storage(t, W) or _shares_storage(t, Hinv):
            raise ValueError(f"obs_downdate: {name} aliases W or Hinv, "
                             "which the kernel updates in place")
    live = d_in if d_live is None else int(d_live)
    if not 0 <= live <= d_in:
        raise ValueError(f"obs_downdate: d_live={d_live} outside [0, {d_in}]")
    if M == 0 or d_in == 0:
        return W, Hinv
    lib = build.load("obs_downdate", _SIGNATURE)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = lib.obs_downdate_f32(
        W.data_ptr(), Hinv.data_ptr(), HcolS.data_ptr(), KsWS.data_ptr(),
        KsHcolT.data_ptr(), keep.data_ptr(), M, d_in, d_out, gs, live, stream)
    build.check(err, "obs_downdate")
    obs_downdate.launches += 1
    return W, Hinv


obs_downdate.launches = 0
