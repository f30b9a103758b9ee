"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (the JAX package's ``optim/compression.py``).

Each rank quantizes its local gradient to int8 against a scale agreed
by a max all-reduce, sums the int8 values as int32 across the data
axes, and dequantizes; the quantization residual is fed back into the
next step's gradient (error feedback keeps the method unbiased over
time). The arithmetic is the reference's, in its order, in fp32;
``torch.round`` rounds half to even as ``jnp.round`` does. As in the
reference the sum travels as int32, so the wire bytes are those of an
fp32 all-reduce.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..distributed.sharding import axis_size
from .adamw import tree_leaves, tree_map


def int8_ef_init(params, nshards: int = 1):
    """The error-feedback residual tree: each leaf ``(nshards, *shape)``
    fp32 zeros on its param's device (each data shard carries its own
    residual of the whole gradient). On a mesh each rank holds its
    ``(1, *shape)`` row (``train_step.state_shardings``)."""
    return tree_map(lambda p: torch.zeros((nshards,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def int8_ef_compress(grads, err, mesh, axes) -> Tuple[dict, dict]:
    """Compress-all-reduce a gradient tree over the ``axes`` of ``mesh``
    (a collective: every rank of those axes calls it with trees of one
    structure). ``err`` is this rank's residual tree, shaped like
    ``grads``. Returns ``(averaged_grads, new_err)``: the averaged
    gradient, the same bits on every rank, and this rank's new
    residual."""
    g = [x.float() + e for x, e in zip(tree_leaves(grads), tree_leaves(err))]
    # the scale consensus: every leaf's max |g|, maxed across the ranks in
    # one all-reduce (a max of each entry alone, so the bits are those of
    # one all-reduce a leaf)
    amax = mesh.all_reduce(torch.stack([x.abs().max() for x in g]), axes,
                           op="max")
    nshards = float(axis_size(mesh, axes))
    avg, new_err = [], []
    for x, a in zip(g, amax):
        scale = torch.clamp(a, min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        total = mesh.all_reduce(q.to(torch.int32), axes)
        avg.append(total.float() * scale / nshards)
        new_err.append(x - q.float() * scale)
    return _rebuild(grads, avg), _rebuild(grads, new_err)


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)
    in place of its leaves."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    return walk(tree)
