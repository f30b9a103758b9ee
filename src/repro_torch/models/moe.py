"""Mixture-of-Experts FFN: token-choice top-k routing with the reference's
sorted capacity dispatch.

The (token, expert) assignments are sorted by expert id (a stable sort,
so within an expert the tokens keep their order), each expert keeps its
first ``capacity`` tokens and the rest go to an overflow slot that is
dropped; the expert SwiGLUs run as batched products over (E, C, d), and
their outputs are scatter-added back with the routing weights. Once
capacity drops tokens this is a different function from a dense gather
over every token, so the dispatch is kept as the reference's.

Ties: ``jax.lax.top_k`` takes the lower expert index first; ``top_k``
here is a stable descending sort, which does the same on every device
(``torch.topk`` promises no order among ties).

Determinism on the card. In an eager forward the combine's ``index_add_``
uses atomics; with top-2 routing a token's output is ``0 + a + b`` in
either order, which rounds the same, and the overflow slot's many
``scatter`` writes land in a row that is sliced off. A train step runs
under ``torch.use_deterministic_algorithms`` (``train.train_step``),
which refuses none of the dispatch's operations: ``bincount`` takes no
weights (integer counts) and ``cumsum`` runs on integers; ``scatter``
with a tensor source and ``index_add_`` take PyTorch's deterministic
paths; and the backward of the ``xpad[disp_tok]`` gather, an
``index_put_`` with accumulation, sums each token's two slot gradients
(and the pad row's many zero ones) after a sort, in a fixed order, as the
scatters' backward gathers. On the card the smoke model's train steps
agree with the CPU's to 1.6e-7 and two repeated full-width steps are
bit-equal (chip_smoke phases 3 and 11).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init

CAPACITY_FACTOR = 1.25


def moe_init(cfg, generator: torch.Generator, nlayers: int):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pfx = (nlayers,)
    return {"router": dense_init(pfx + (d, e), generator),
            "wg": dense_init(pfx + (e, d, f), generator),
            "wu": dense_init(pfx + (e, d, f), generator),
            "wd": dense_init(pfx + (e, f, d), generator)}


def capacity(tokens: int, cfg) -> int:
    """Slots per expert: the expected share times ``CAPACITY_FACTOR``,
    rounded up to 8 (at least 8). Read at call time, so a caller can
    lift the module constant to rule drops out."""
    c = int(math.ceil(tokens * cfg.num_experts_per_tok / cfg.num_experts
                      * CAPACITY_FACTOR))
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among ties (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xf: torch.Tensor, k: int):
    """The fp32 router softmax over every expert column, its top-k and
    the renormalised top-k weights: (probs (t, E), topw (t, k), topi)."""
    logits = (xf @ router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, topw, topi


def moe_apply(cfg, p, x: torch.Tensor, capture=None):
    """x (B, S, d) -> (y (B, S, d), aux). With ``capture``, writes the
    per-expert down-projection inputs ``wd_in`` (E, C, f) and their
    validity ``wd_valid`` (E, C): a slot no token filled holds zeros."""
    dt = x.dtype
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    c = capacity(t, cfg)
    dev = x.device

    xf = x.reshape(t, d)
    probs, topw, topi = route(p["router"], xf, k)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    ce = F.one_hot(topi[:, 0], e).float().mean(0)
    aux = e * (me * ce).sum()

    # ---- sorted capacity dispatch ----
    flat_e = topi.reshape(-1)                              # (t*k,)
    flat_w = topw.reshape(-1).to(dt)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sw, stok = flat_e[order], flat_w[order], flat_tok[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts              # segment starts
    pos = torch.arange(t * k, device=dev) - starts[se]
    buf_idx = torch.where(pos < c, se * c + pos, e * c)    # overflow slot
    # every kept assignment has its own slot; only the dropped overflow
    # slot is written more than once
    disp_tok = torch.full((e * c + 1,), t, dtype=torch.long, device=dev
                          ).scatter(0, buf_idx, stok)[:-1].reshape(e, c)
    disp_w = torch.zeros((e * c + 1,), dtype=dt, device=dev
                         ).scatter(0, buf_idx, sw)[:-1].reshape(e, c)

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    gathered = xpad[disp_tok]                              # (e, c, d)
    g = torch.bmm(gathered, p["wg"].to(dt))
    u = torch.bmm(gathered, p["wu"].to(dt))
    h = F.silu(g) * u
    if capture is not None:
        capture["wd_in"] = h                               # (e, c, f)
        capture["wd_valid"] = disp_tok < t
    y = torch.bmm(h, p["wd"].to(dt)) * disp_w[..., None]
    out = torch.zeros((t + 1, d), dtype=dt, device=dev).index_add_(
        0, disp_tok.reshape(-1), y.reshape(-1, d))[:t]
    return out.reshape(b, s, d), aux
