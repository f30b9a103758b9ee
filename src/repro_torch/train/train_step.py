"""The train step: microbatch gradient accumulation, optional
distillation against a frozen teacher, global-norm clipping, the LR
schedule, AdamW, and the pruning masks multiplied into the params after
each update (m and v are left unmasked, as the reference leaves them).

The state keeps fp32 master params; the forward casts to ``cfg.dtype`` at
use. The step is a function of the state: it returns a new ``TrainState``
and never writes the one it was given, so the trainer's loss guard can
drop an update and a queued checkpoint can never see a later step.

Determinism: every step runs under ``torch.use_deterministic_algorithms``
(restored on exit, so nothing outside the step changes mode). Backward
passes of the forward accumulate: the embedding lookup where tokens
repeat (GPT-2 ties its table to the unembedding), the ``gather`` of the
cross-entropy, and an MoE layer's dispatch (``models.moe``). The mode
makes them deterministic on CUDA, so a resumed run gives the bits of an
uninterrupted one. On CUDA it needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``) in the environment
before the process's first cuBLAS call; PyTorch raises at the step's
first product otherwise. ``launch.train`` sets it.

``grad_compression="int8_ef"`` compresses a data-parallel all-reduce,
which one device does not have: it raises, as the reference's does
without a mesh. The mesh path (``jit_train_step``, ``state_shardings``)
is not ported.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple

import torch

from ..configs.base import TrainConfig
from ..distill.losses import distillation_loss
from ..models.model import loss_fn
from ..models.transformer import tree_to
from ..optim.adamw import (adamw_init, adamw_update, clip_by_global_norm,
                           tree_leaves, tree_map)
from ..optim.schedule import make_schedule
from ..runtime.device import DeviceLike, resolve_device


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor          # 0-d int32, on the params' device
    ef_err: Any = None          # int8 error-feedback residuals (not ported)


def _check_compression(tcfg: TrainConfig) -> None:
    if tcfg.grad_compression == "int8_ef":
        raise ValueError(
            "grad_compression='int8_ef' compresses the data-parallel "
            "all-reduce and needs a mesh with data axes; the port trains on "
            "one device, where the configuration would silently train "
            "uncompressed")
    if tcfg.grad_compression != "none":
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}")


def make_train_state(cfg, params, tcfg: TrainConfig) -> TrainState:
    _check_compression(tcfg)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, then
    the caller's setting again."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _split_microbatches(batch: Dict, n: int):
    """(B, ...) -> n microbatches of B/n rows each."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def _key_paths(tree, prefix=()):
    """The key paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], prefix + (k,))]
    return [prefix]


def _check_mask_tree(mask_paths, params) -> None:
    """Raise unless the mask tree had exactly the params' key paths: the
    step pairs mask and weight by their index in ``tree_leaves`` order,
    so a missing or extra key would mask the wrong leaf (the reference's
    ``jax.tree.map`` over params and masks raises a ValueError too)."""
    want = _key_paths(params)
    if mask_paths != want:
        missing = sorted(set(want) - set(mask_paths))
        extra = sorted(set(mask_paths) - set(want))
        raise ValueError(
            "the masks tree does not have the params' structure: "
            f"missing {['/'.join(p) for p in missing]}, extra "
            f"{['/'.join(p) for p in extra]}")


def _mask_leaves(masks, dev):
    """The leaves of a mask tree that change a weight, on ``dev`` by their
    index in ``tree_leaves`` order; a {0,1} leaf as bool. Multiplying by 1
    leaves a weight's bits as they are and a bool multiplies as its 0/1,
    so applying these in place gives the bits of ``p * m`` over the whole
    tree without a params-sized tree of ones on the device (5.3 GiB at
    one full-width Phi-3.5-MoE layer). The index is only right for a mask
    tree with the params' key paths (``_check_mask_tree``)."""
    out = []
    for i, m in enumerate(tree_leaves(masks) if masks is not None else []):
        m = m.to(dev)
        if bool((m == 1).all()):
            continue
        out.append((i, m.bool() if bool(((m == 0) | (m == 1)).all())
                    else m))
    return out


def make_train_step(cfg, tcfg: TrainConfig, *, teacher_params=None,
                    masks=None, device: DeviceLike = None):
    """Build the train step ``step(state, batch) -> (new_state,
    metrics)`` on ``device`` (the card unless the caller asks for the
    CPU). masks: optional params-shaped {0,1} tree multiplied into the
    params after each update (gradual pruning keeps pruned structures at
    zero). The teacher and the masks are moved to the device once; the
    state's params must already live there; a step raises a ValueError
    if the masks' key paths are not the params'. Metrics are 0-d tensors:
    ``loss``, ``task_loss``, ``logit_kl``, ``token_l2`` (each the mean over
    microbatches), ``grad_norm`` and ``lr``."""
    dev = resolve_device(device)
    _check_compression(tcfg)
    schedule = make_schedule(tcfg.learning_rate, tcfg.warmup_steps,
                             tcfg.total_steps)
    teacher = tree_to(teacher_params, dev)
    mask_leaves = _mask_leaves(masks, dev)
    mask_paths = _key_paths(masks) if masks is not None else None
    del masks

    def grads_of(params, mb):
        """(aux metrics, grads) of one microbatch."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, aux = distillation_loss(
            cfg, live, teacher, mb, l_task=tcfg.distill_task,
            l_logit=tcfg.distill_logit, l_token=tcfg.distill_token)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        by_leaf = {id(p): (torch.zeros_like(p) if g is None else g)
                   for p, g in zip(leaves, grads)}
        aux = {k: v.detach() for k, v in aux.items()}
        return aux, tree_map(lambda p: by_leaf[id(p)], live)

    def accum_grads(params, batch):
        n_micro = tcfg.microbatches
        if n_micro == 1:
            return grads_of(params, batch)
        g_acc, auxes = None, []
        for mb in _split_microbatches(batch, n_micro):
            aux, g = grads_of(params, mb)
            auxes.append(aux)
            g_acc = (tree_map(lambda a: a.float(), g) if g_acc is None else
                     tree_map(lambda a, b: a + b.float(), g_acc, g))
        aux = {k: torch.stack([a[k] for a in auxes]).mean(0) for k in auxes[0]}
        return aux, tree_map(lambda g: g / n_micro, g_acc)

    def train_step(state: TrainState, batch: Dict):
        params = state.params
        where = tree_leaves(params)[0].device
        # a device named without an index ("cuda") takes any index
        if where.type != dev.type or dev.index not in (None, where.index):
            raise ValueError(f"the train step runs on {dev}, but the "
                             f"state's params are on {where}")
        if mask_paths is not None:
            _check_mask_tree(mask_paths, params)
        with deterministic_algorithms():
            aux, grads = accum_grads(params, batch)
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            lr = schedule(state.step)
            new_params, new_opt = adamw_update(
                grads, state.opt, params, lr=lr, b1=tcfg.beta1,
                b2=tcfg.beta2, weight_decay=tcfg.weight_decay)
            leaves = tree_leaves(new_params)  # adamw_update's new tensors
            for i, m in mask_leaves:
                leaves[i].mul_(m)
        metrics = {**aux, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef_err=state.ef_err), metrics

    return train_step


def make_eval_step(cfg):
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(cfg, params, batch)["loss"]

    return eval_step
