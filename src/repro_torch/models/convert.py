"""Weight bridge: a JAX-package params tree, given as numpy arrays, into
the port's params.

Both packages store the same nested dict with the same layouts (stacked
layer leaves, ``y = x @ W``; an MoE layer's ``moe.router`` (L, d, E) and
its experts' ``moe.wg``/``moe.wu`` (L, E, d, f) and ``moe.wd``
(L, E, f, d)), so the bridge is a tensor copy per leaf and weights are
never re-drawn. Convert a JAX tree first with
``jax.tree.map(np.asarray, params)``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..runtime.device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None
                      ) -> Dict[str, Any]:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params as a nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
