"""Mamba-2 SSD (state-space duality) layer: the chunked scan for train and
prefill, and the single-token recurrent decode step.

The port of the JAX package's ``models/ssm.py``, with its separate
z/x/B/C/dt projections and its leaf names and shapes, so
``models.convert`` carries the reference's weights across unchanged.
The chunked scan ``ssd_chunked`` is ``kernels.ssd_scan.ssd_chunked``: its
intra-chunk pass is the hand-written SSD kernel for CUDA tensors and its
plain version on the CPU.

``ssm_apply`` reads the head count and inner width from the weights it
is given, so it also runs a layer whose SSD heads were shrunk away by
ZipLM (``models.pruned``). The same three functions run the SSD heads of
a hybrid (Hymba) block beside its attention (``models.transformer``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_chunked
from .layers import dense_init


def ssm_init(cfg, generator: torch.Generator, nlayers: int
             ) -> Dict[str, torch.Tensor]:
    """Seeded fp32 SSD weights with a leading layer axis, drawn in the
    reference's order."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, k = cfg.ssm_heads, cfg.ssm_conv
    pfx = (nlayers,)
    g = generator
    return {
        "in_z": dense_init(pfx + (d, di), g),
        "in_x": dense_init(pfx + (d, di), g),
        "in_bc": dense_init(pfx + (d, 2 * n), g),
        "in_dt": dense_init(pfx + (d, h), g),
        "conv_x": dense_init(pfx + (k, di), g) * 0.1,
        "conv_x_b": torch.zeros(pfx + (di,)),
        "conv_bc": dense_init(pfx + (k, 2 * n), g) * 0.1,
        "conv_bc_b": torch.zeros(pfx + (2 * n,)),
        "A_log": torch.zeros(pfx + (h,)),
        "D": torch.ones(pfx + (h,)),
        "dt_bias": torch.full(pfx + (h,), -1.0),
        "norm": torch.ones(pfx + (di,)),
        "out_proj": dense_init(pfx + (di, d), g),
    }


def _gated_headnorm(y, scale, head_dim: int):
    """Grouped (per-head) RMSNorm over the last dim split into heads, with
    the reference's own fixed epsilon of 1e-5."""
    shp = y.shape
    yf = y.float().reshape(*shp[:-1], shp[-1] // head_dim, head_dim)
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-5)
    return (yf.reshape(shp) * scale).to(y.dtype)


def causal_conv1d(x, w, b):
    """Depthwise causal 1D conv as K shift-multiply-adds in x's type.
    x: (B, S, C), w: (K, C), b: (C,). Not ``F.conv1d``: cuDNN would run
    an fp32 convolution in TF32 unless told otherwise."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = b.to(x.dtype)
    for j in range(k):
        out = out + w[j].to(x.dtype) * xp[:, j:j + s]
    return out


def _project(p, x):
    dt_ = x.dtype
    return tuple(x @ p[k].to(dt_) for k in ("in_z", "in_x", "in_bc", "in_dt"))


def ssm_apply(cfg, p, x, capture=None, return_cache: bool = False):
    """Full SSD block for train/prefill: x (B, S, D) -> (B, S, D). Writes
    the out-projection input to ``capture["ssm_out_in"]``; with
    ``return_cache`` also returns the decode cache {state, conv_x,
    conv_bc}, whose conv tails are the last K-1 raw projections (the
    ones this forward computed, not a second projection)."""
    dt_ = x.dtype
    b, s, _ = x.shape
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    h = p["A_log"].shape[-1]
    di = h * hp

    z, xs_raw, bc_raw, dt = _project(p, x)
    xs = F.silu(causal_conv1d(xs_raw, p["conv_x"], p["conv_x_b"]))
    bc = F.silu(causal_conv1d(bc_raw, p["conv_bc"], p["conv_bc_b"]))
    B, C = bc[..., :n], bc[..., n:]

    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, h, hp)
    y, final_state = ssd_chunked(xh, dtv, A, B, C, cfg.ssm_chunk)
    cache = None
    if return_cache:
        k = cfg.ssm_conv
        tails = [F.pad(t[:, -(k - 1):], (0, 0, max(0, k - 1 - s), 0))
                 for t in (xs_raw, bc_raw)]
        cache = {"state": final_state, "conv_x": tails[0],
                 "conv_bc": tails[1]}
    y = y + p["D"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(b, s, di)

    # per-head gated RMSNorm: removed heads cannot shift kept heads' norm
    y = _gated_headnorm(y * F.silu(z), p["norm"], hp)
    if capture is not None:
        capture["ssm_out_in"] = y        # inputs to out_proj (ZipLM target)
    out = y @ p["out_proj"].to(dt_)
    return (out, cache) if return_cache else out


def init_ssm_cache(cfg, batch: int, nlayers: int, dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    di, n = cfg.d_inner, cfg.ssm_state
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "state": torch.zeros((nlayers, batch, h, hp, n), device=device),
        "conv_x": torch.zeros((nlayers, batch, cfg.ssm_conv - 1, di),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((nlayers, batch, cfg.ssm_conv - 1, 2 * n),
                               dtype=dtype, device=device),
    }


def ssm_decode_step(cfg, p, x, cache):
    """Single-token recurrent step (plain PyTorch, as in the reference).
    x (B, 1, D); cache per layer {state, conv_x, conv_bc}. Returns
    (y (B, 1, D), cache) with the cache's tensors updated in place."""
    dt_ = x.dtype
    b = x.shape[0]
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    h = p["A_log"].shape[-1]
    di = h * hp

    z, xs_r, bc_r, dt = _project(p, x)
    # conv rings: window = [cache | current]
    win_x = torch.cat([cache["conv_x"], xs_r[:, :1]], dim=1)
    win_bc = torch.cat([cache["conv_bc"], bc_r[:, :1]], dim=1)
    xs = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x"].to(dt_))
                + p["conv_x_b"].to(dt_))
    bc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc"].to(dt_))
                + p["conv_bc_b"].to(dt_))
    B, C = bc[..., :n], bc[..., n:]

    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, h, hp).float()
    dA = torch.exp(dtv * A)                                     # (b,h)
    state = (cache["state"] * dA[..., None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dtv, B.float(), xh))
    y = torch.einsum("bn,bhpn->bhp", C.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, di).to(dt_)

    y = _gated_headnorm(y * F.silu(z), p["norm"], hp)
    out = y @ p["out_proj"].to(dt_)
    cache["state"].copy_(state)
    cache["conv_x"].copy_(win_x[:, 1:])
    cache["conv_bc"].copy_(win_bc[:, 1:])
    return out, cache
