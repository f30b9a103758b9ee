"""Named mesh axes over the ranks of a ``torch.distributed`` process
group, and the data-axis helpers of the JAX package's
``distributed/sharding.py``.

The JAX package shards with ``shard_map`` over a device mesh in one
process. The port runs one process per rank (``launch.subproc``): a
:class:`Mesh` lays the process group's ranks out row-major over named
axes, holds one process group per combination of axes, and runs the
collectives that the sharded calibration and database need, each
staged through host memory (the groups are gloo; see
``launch/subproc.py``). Each rank ends with the replicated result that
the reference's ``P()`` outputs give.

Only the data-axis half is ported: ``axis_size``, ``data_axes_for``,
``pad_leading`` and ``batch_axes``. The partition-spec half
(``logical_to_pspec``, ``param_shardings``, ``batch_sharding``,
``cache_shardings``, ``mesh_config_for``) belongs to the mesh trainer
(ROADMAP Queue 1 item 6c) and comes with it.
"""
from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Union[None, str, Sequence[str]]


class Mesh:
    """The ranks ``0..prod(shape)-1`` laid out row-major over ``axes``.

    ``shape`` maps each axis to its size and ``axis_names`` keeps their
    order, as on a JAX mesh. :func:`make_mesh` gives it, for each tuple
    of axes (in mesh order), the process group of this rank's peers over
    those axes; a mesh without groups still answers the shape questions
    (``axis_size``, ``index``)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.shape = dict(zip(axes, (int(s) for s in shape)))
        self.axis_names = tuple(axes)
        self.rank = int(rank)
        self.size = int(np.prod(list(self.shape.values())))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple in mesh order (``None``: every axis)."""
        axes = self.axis_names if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def index(self, axes: Axes = None) -> int:
        """This rank's shard over ``axes``: its row-major position among
        the shards, the rank's index in the group of those axes."""
        axes = self._axes(axes)
        c = self.coords()
        return int(np.ravel_multi_index(tuple(c[a] for a in axes),
                                        tuple(self.shape[a] for a in axes))
                   ) if axes else 0

    def group(self, axes: Axes = None):
        return self._groups[self._axes(axes)]

    # -- collectives, through host memory ------------------------------
    def all_reduce(self, t: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        """The sum of ``t`` over the shards of ``axes``, on ``t``'s
        device, the same bits on every rank."""
        import torch.distributed as dist
        h = t.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(h, group=self.group(axes))
        return h.to(t.device)

    def any(self, flag: bool, axes: Axes = None) -> bool:
        """Whether ``flag`` is true on any shard of ``axes``."""
        return bool(self.all_reduce(torch.tensor([int(flag)]), axes)[0])

    def all_gather(self, a: np.ndarray, axes: Axes = None) -> np.ndarray:
        """Every shard's host array ``a`` (same shape and dtype on every
        shard), concatenated along axis 0 in shard order, bit for bit."""
        import torch.distributed as dist
        a = np.ascontiguousarray(a)
        raw = torch.from_numpy(a.reshape(-1).view(np.uint8))
        group = self.group(axes)
        parts = [torch.empty_like(raw)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, raw, group=group)
        return np.concatenate([p.numpy().view(a.dtype).reshape(a.shape)
                               for p in parts])

    def broadcast_object(self, obj, axes: Axes = None):
        """The picklable ``obj`` of the first shard of ``axes``, on every
        shard (the others pass anything, say None)."""
        import torch.distributed as dist
        box = [obj]
        group = self.group(axes)
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(group, 0), group=group)
        return box[0]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A :class:`Mesh` over the initialised default process group, whose
    size must be ``prod(shape)``. Every rank calls it, in the same order
    as its other group creations: it creates, collectively, the groups
    of every combination of axes (the whole world for all of them)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(launch.subproc.init_rank in a rank of "
                           "launch.subproc.run_ranks)")
    mesh = Mesh(shape, axes, rank=dist.get_rank())
    if mesh.size != dist.get_world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{mesh.size} ranks; the group has "
                         f"{dist.get_world_size()}")
    dims = tuple(mesh.shape.values())
    grid = np.arange(mesh.size).reshape(dims)
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            key = tuple(mesh.axis_names[i] for i in sub)
            if k == len(axes):
                mesh._groups[key] = dist.group.WORLD
                continue
            # one group per setting of the other axes, created in the
            # same order on every rank; this rank keeps its own
            rest = [i for i in range(len(axes)) if i not in sub]
            moved = np.moveaxis(grid, rest, range(len(rest)))
            for ranks in moved.reshape(-1, int(np.prod(
                    [dims[i] for i in sub]))):
                g = dist.new_group([int(r) for r in ranks])
                if mesh.rank in ranks:
                    mesh._groups[key] = g
    return mesh


def axis_size(mesh: Mesh, axes: Axes) -> int:
    """Total number of shards over ``axes`` (None -> 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def data_axes_for(mesh: Mesh) -> Tuple[str, ...]:
    """Default data-parallel axes of a mesh: the conventional ("pod",
    "data") names when present, else every axis (pure-DP meshes)."""
    named = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return named or tuple(mesh.axis_names)


def pad_leading(arr: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad ``arr``'s leading axis up to a ``multiple`` by replicating the
    first slice (a real, finite element: padded lanes run the same
    numerics as live ones). Callers slice the result back to the
    original length."""
    pad = (-arr.shape[0]) % max(multiple, 1)
    if pad == 0:
        return arr
    return torch.cat([arr, arr[:1].expand(pad, *arr.shape[1:])])


def batch_axes(mesh: Mesh, data_axes: Sequence[str], batch: int):
    """The data axes a batch of ``batch`` rows shards over: all of them
    when they divide it, else the first alone, else None. The reference
    takes a ``MeshConfig`` and reads its ``data_axes``; the port has no
    ``MeshConfig`` until the mesh trainer (item 6c), so the caller passes
    them."""
    axes = tuple(data_axes)
    if batch % axis_size(mesh, axes) == 0:
        return axes
    for sub in (axes[:1], ()):
        if not sub or batch % axis_size(mesh, sub) == 0:
            return sub or None
    return None
