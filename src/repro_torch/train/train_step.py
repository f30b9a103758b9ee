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

Mesh path (``mesh=``, ``mc=`` and ``specs=``, the logical axis names of
``models.model_specs``; the reference's ``jit_train_step``): each rank
holds its FSDP slice of params, m and v (``state_shardings``,
``distributed.sharding.shard_tree``) and of the teacher, and one step

* gathers the whole params (and teacher) for the forward;
* fp32 (``grad_compression="none"``): splits the *global* batch into
  microbatches and takes its share of each (rank r the r-th part of
  every microbatch over the data axes that divide it, as the
  reference's ``_split_microbatches`` pins it), sums the gradients and
  the aux metrics over those ranks and divides by their number;
* ``int8_ef``: takes its contiguous share of the batch first and splits
  that into microbatches (the reference's ``shard_map`` body), then
  ``optim.compression.int8_ef_compress`` with its residual row
  ``ef_err`` (``(1, *shape)`` a leaf) and averages the aux metrics;
* clips by the norm of the whole gradient (the same bits on every
  rank) and runs AdamW and the masks on its slices: AdamW is
  elementwise, so a slice's update has the bits of the whole update's
  slice.

Averaging the ranks' means is the global mean when the ranks hold as
many counted tokens each, as every unmasked batch does; for masked-LM
batches (an encoder's random masks) the fp32 path differs from the
reference's global mean by that weighting. A mesh whose ``"model"``
axis is larger than 1 raises NotImplementedError: tensor parallelism is
ROADMAP Queue 1 item 6d.

``grad_compression="int8_ef"`` compresses a data-parallel all-reduce,
which one device does not have: without a mesh it raises, as the
reference's does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..configs.base import MeshConfig, TrainConfig
from ..distill.losses import distillation_loss
from ..distributed.sharding import (axis_size, batch_axes, gather_tree,
                                    mesh_config_for, param_shardings, pspec,
                                    shard_tree)
from ..models.model import loss_fn
from ..models.transformer import param_shapes, tree_to
from ..optim.adamw import (adamw_init, adamw_update, clip_by_global_norm,
                           clip_scale, global_norm, tree_leaves, tree_map)
from ..optim.compression import int8_ef_compress, int8_ef_init
from ..optim.schedule import make_schedule
from ..runtime.device import DeviceLike, resolve_device


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor          # 0-d int32, on the params' device
    ef_err: Any = None          # int8 error-feedback residuals (a mesh's)


def _ef_nshards(tcfg: TrainConfig, mesh, mc: Optional[MeshConfig]) -> int:
    """The number of shards the error-feedback residual is carried over
    (0 without compression); raises on a compression without data
    axes."""
    if tcfg.grad_compression == "none":
        return 0
    if tcfg.grad_compression != "int8_ef":
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}")
    if mesh is None or mc is None or not tuple(mc.data_axes):
        raise ValueError(
            "grad_compression='int8_ef' compresses the data-parallel "
            "all-reduce and needs a mesh with data axes (pass mesh= and "
            "mc= / MeshConfig with non-empty data_axes); without them the "
            "configuration would silently train uncompressed")
    return axis_size(mesh, tuple(mc.data_axes))


def refuse_model_axis(mesh) -> None:
    """Raise for a mesh whose ``"model"`` axis has more than one rank."""
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with a 'model' axis of {mesh.shape['model']} ranks: "
            "tensor parallelism over 'model' is not ported yet (ROADMAP "
            "Queue 1 item 6d); train over data axes only")


def make_train_state(cfg, params, tcfg: TrainConfig, *, mesh=None,
                     mc: Optional[MeshConfig] = None) -> TrainState:
    """A fresh state for the whole ``params``; with ``int8_ef`` (which
    needs ``mesh`` and ``mc``) the residual tree is ``(nshards, *shape)``
    zeros, one row a data shard. ``shard_tree(state, state_shardings(
    ...), mesh)`` gives a rank its slice."""
    n = _ef_nshards(tcfg, mesh, mc)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      ef_err=int8_ef_init(params, n) if n else None)


def state_shardings(mesh, mc: MeshConfig, state: TrainState, specs):
    """The spec of each leaf of a whole ``state`` (a ``TrainState`` of
    specs): params, m and v by ``param_shardings``, the residuals' rows
    over the data axes, the counters replicated."""
    psh = param_shardings(mesh, mc, state.params, specs)
    ef = None
    if state.ef_err is not None:
        ef = tree_map(lambda _: pspec(tuple(mc.data_axes)), state.ef_err)
    return TrainState(params=psh, opt={"m": psh, "v": psh, "count": ()},
                      step=(), ef_err=ef)


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
    return [_rows(batch, i, b // n) for i in range(n)]


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
                    masks=None, mesh=None, mc: Optional[MeshConfig] = None,
                    specs=None, device: DeviceLike = None):
    """Build the train step ``step(state, batch) -> (new_state,
    metrics)`` on ``device`` (the card unless the caller asks for the
    CPU). masks: optional params-shaped {0,1} tree multiplied into the
    params after each update (gradual pruning keeps pruned structures at
    zero). The teacher and the masks are moved to the device once (on a
    mesh, this rank's slices of them); the state's params must already
    live there; a step raises a ValueError if the masks' key paths are
    not the params'. Metrics are 0-d tensors: ``loss``, ``task_loss``,
    ``logit_kl``, ``token_l2`` (each the mean over microbatches, and on a
    mesh over the ranks), ``grad_norm`` and ``lr``.

    With ``mesh`` (``mc`` defaults to ``mesh_config_for(mesh)``; ``specs``
    is required) the step takes and returns a rank's slice of the state
    (module docstring); every rank of the mesh calls it with the same
    batch."""
    dev = resolve_device(device)
    if mesh is not None:
        if specs is None:
            raise ValueError("make_train_step(mesh=...) needs the model's "
                             "logical axis specs (models.model_specs)")
        refuse_model_axis(mesh)
        mc = mc if mc is not None else mesh_config_for(mesh)
    compress = _ef_nshards(tcfg, mesh, mc) > 0
    schedule = make_schedule(tcfg.learning_rate, tcfg.warmup_steps,
                             tcfg.total_steps)
    pspecs = (param_shardings(mesh, mc, param_shapes(cfg), specs)
              if mesh is not None else None)

    def local(tree):
        """This rank's slices of a whole tree (on a mesh)."""
        return tree if mesh is None else shard_tree(tree, pspecs, mesh)

    teacher = local(tree_to(teacher_params, dev))
    mask_leaves = _mask_leaves(local(tree_to(masks, dev)), dev)
    mask_paths = _key_paths(masks) if masks is not None else None
    del masks

    def grads_of(params, teacher, mb):
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

    def accum(params, teacher, mbs):
        """(aux, grads) over the microbatches ``mbs``: the grads' sum
        over them divided by their number, the aux metrics' mean."""
        if len(mbs) == 1:
            return grads_of(params, teacher, mbs[0])
        g_acc, auxes = None, []
        for mb in mbs:
            aux, g = grads_of(params, teacher, mb)
            auxes.append(aux)
            g_acc = (tree_map(lambda a: a.float(), g) if g_acc is None else
                     tree_map(lambda a, b: a + b.float(), g_acc, g))
        aux = {k: torch.stack([a[k] for a in auxes]).mean(0) for k in auxes[0]}
        return aux, tree_map(lambda g: g / len(mbs), g_acc)

    def mean_over(aux, grads, axes, n):
        """The aux metrics' and the grads' mean over the ``n`` ranks of
        ``axes`` (sums staged through the host, then divided)."""
        keys = sorted(aux)
        tot = mesh.all_reduce(torch.stack([aux[k] for k in keys]), axes)
        aux = {k: tot[i] / n for i, k in enumerate(keys)}
        if grads is not None:
            grads = tree_map(lambda g: mesh.all_reduce(g, axes) / n, grads)
        return aux, grads

    def mesh_grads(params, teacher, batch, ef):
        """(aux, whole grads, new residual rows) on a mesh."""
        b = batch["tokens"].shape[0]
        mbs = _split_microbatches(batch, tcfg.microbatches)
        if compress:
            axes = tuple(mc.data_axes)
            n = axis_size(mesh, axes)
            if b % n:
                raise ValueError(f"int8_ef: a batch of {b} rows does not "
                                 f"split over the {n} data shards")
            rows = _rows(batch, mesh.index(axes), b // n)
            aux, grads = accum(params, teacher, _split_microbatches(
                rows, tcfg.microbatches))
            grads, new_ef = int8_ef_compress(
                grads, tree_map(lambda e: e[0], ef), mesh, axes)
            aux, _ = mean_over(aux, None, axes, n)
            return aux, grads, tree_map(lambda e: e[None], new_ef)
        axes = batch_axes(mesh, mc, b // tcfg.microbatches)
        n = axis_size(mesh, axes)
        part = mesh.index(axes) if axes else 0
        aux, grads = accum(params, teacher,
                           [_rows(mb, part, mb["tokens"].shape[0] // n)
                            for mb in mbs])
        if n > 1:
            aux, grads = mean_over(aux, grads, axes, n)
        return aux, grads, ef

    def train_step(state: TrainState, batch: Dict):
        params = state.params
        where = tree_leaves(params)[0].device
        # a device named without an index ("cuda") takes any index
        if where.type != dev.type or dev.index not in (None, where.index):
            raise ValueError(f"the train step runs on {dev}, but the "
                             f"state's params are on {where}")
        if mask_paths is not None:
            _check_mask_tree(mask_paths, params)
        new_ef = state.ef_err
        with deterministic_algorithms():
            if mesh is None:
                aux, grads = accum(params, teacher, _split_microbatches(
                    batch, tcfg.microbatches))
                grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            else:
                aux, grads, new_ef = mesh_grads(
                    gather_tree(params, pspecs, mesh),
                    gather_tree(teacher, pspecs, mesh), batch, state.ef_err)
                # the whole gradient's norm (the same bits on every rank),
                # then the clip and AdamW on this rank's slices
                gnorm = global_norm(grads)
                scale = clip_scale(gnorm, tcfg.grad_clip)
                grads = tree_map(lambda g: g * scale, local(grads))
            lr = schedule(state.step)
            new_params, new_opt = adamw_update(
                grads, state.opt, params, lr=lr, b1=tcfg.beta1,
                b2=tcfg.beta2, weight_decay=tcfg.weight_decay)
            leaves = tree_leaves(new_params)  # adamw_update's new tensors
            for i, m in mask_leaves:
                leaves[i].mul_(m)
        metrics = {**aux, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef_err=new_ef), metrics

    return train_step


def _rows(batch: Dict, part: int, size: int) -> Dict:
    """Rows ``[part * size, (part + 1) * size)`` of every batch entry."""
    return {k: v[part * size:(part + 1) * size] for k, v in batch.items()}


def make_eval_step(cfg):
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(cfg, params, batch)["loss"]

    return eval_step
