"""Weight bridge: a JAX-package params tree, given as numpy arrays, into
the port's params.

Both packages store the same nested dict with the same layouts (stacked
layer leaves, ``y = x @ W``; an MoE layer's ``moe.router`` (L, d, E) and
its experts' ``moe.wg``/``moe.wu`` (L, E, d, f) and ``moe.wd``
(L, E, f, d)), so the bridge is a tensor copy per leaf and weights are
never re-drawn. Convert a JAX tree first with
``jax.tree.map(np.asarray, params)``. ``train_state_from_numpy`` moves a
whole reference ``TrainState`` (params, AdamW's m, v and count, the
step, and the int8 error-feedback residuals) over the same way, so a JAX
run and a port run continue from one state.
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


def train_state_from_numpy(state, device: DeviceLike = None, mesh=None):
    """The reference's ``TrainState`` given as numpy (``jax.tree.map(
    np.asarray, state)``) as the port's ``train.TrainState``. Its int8
    error-feedback residuals (``ef_err``, ``(nshards, *shape)`` a leaf)
    come over whole, or with ``mesh`` as this rank's row (``(1,
    *shape)``: row ``mesh.index(data_axes)``, the data axes of
    ``mesh_config_for(mesh)``), the residual the mesh train step
    carries; params, m and v stay whole (``distributed.shard_tree`` with
    ``train_step.state_shardings`` gives a rank its slices)."""
    from ..distributed.sharding import mesh_config_for
    from ..train.train_step import TrainState
    dev = resolve_device(device)

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)

    ef = None
    if state.ef_err is not None:
        ef = state.ef_err
        if mesh is not None:
            axes = mesh_config_for(mesh).data_axes
            row = mesh.index(axes)

            def take(node):
                if isinstance(node, dict):
                    return {k: take(v) for k, v in node.items()}
                return np.asarray(node)[row:row + 1]

            ef = take(ef)
        ef = params_from_numpy(ef, dev)
    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, dev),
        opt={"m": params_from_numpy(opt["m"], dev),
             "v": params_from_numpy(opt["v"], dev),
             "count": scalar(opt["count"])},
        step=scalar(state.step), ef_err=ef)
