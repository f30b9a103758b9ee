"""AdamW on params trees (nested dicts of tensors), with the reference's
arithmetic: fp32 moments, bias corrections from ``count + 1``,
``sqrt(v / bc2) + eps`` in the denominator, and weight decay added to the
step before it is scaled by ``lr``.

No ``torch.optim``: the state is the reference's dict ``{"m", "v",
"count"}``, so it checkpoints and crosses over between the two packages
as it is. Every function returns new tensors and leaves its inputs as
they were, so a caller can still drop an update (the trainer's loss
guard) after it was computed.
"""
from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """Leaves in the reference's order (``jax.tree.leaves`` sorts keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params):
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    dev = tree_leaves(params)[0].device
    return {"m": zeros,
            "v": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a gradient of global norm ``norm`` within
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    count = state["count"] + 1
    cf = count.to(torch.float32)

    def upd_m(m, g):
        return b1 * m + (1 - b1) * g.float()

    def upd_v(v, g):
        g = g.float()
        return b2 * v + (1 - b2) * g * g

    m = tree_map(upd_m, state["m"], grads)
    v = tree_map(upd_v, state["v"], grads)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf

    def upd_p(p, m_, v_):
        # (m_ / bc1) / (sqrt(v_ / bc2) + eps), plus the decay, times lr:
        # the same operations in the same order, on two temporaries (the
        # largest leaf of a full-width MoE layer is 1.6 GB)
        den = torch.sqrt(v_ / bc2).add_(eps)
        step = (m_ / bc1).div_(den)
        del den
        if weight_decay:
            step.add_(weight_decay * p.float())
        return (p.float() - step.mul_(lr)).to(p.dtype)

    new_params = tree_map(upd_p, params, m, v)
    return new_params, {"m": m, "v": v, "count": count}
