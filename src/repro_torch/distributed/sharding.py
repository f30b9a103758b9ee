"""Named mesh axes over the ranks of a ``torch.distributed`` process
group, and the JAX package's ``distributed/sharding.py``: the data-axis
helpers and the logical-axis rules that map a parameter's axis names to
mesh axes.

The JAX package shards with ``shard_map`` and ``NamedSharding`` over a
device mesh in one process. The port runs one process per rank
(``launch.subproc``): a :class:`Mesh` lays the process group's ranks
out row-major over named axes, holds one process group per combination
of axes, and runs the collectives, each staged through host memory (the
groups are gloo; see ``launch/subproc.py``).

A port *spec* stands for the reference's ``PartitionSpec``: a tuple of
one entry per leading dim, each an axis name, a tuple of names, or
``None`` (replicated); dims past its end are replicated, and a tuple
of one name is that name (:func:`pspec`), as in a ``PartitionSpec``.
:func:`logical_to_pspec`, :func:`param_shardings`,
:func:`batch_sharding` and :func:`cache_shardings` return specs where
the reference returns shardings. :func:`shard_of` gives a rank its
slice of a whole tensor under a spec and :func:`gather_shards` puts the
whole back together from every rank's slice; :func:`shard_tree` and
:func:`gather_tree` do both over a tree of tensors and its tree of
specs.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs.base import MeshConfig

Axes = Union[None, str, Sequence[str]]
# process groups a combination of axes holds, each a gloo connection of
# its own: a large all-reduce runs as this many concurrent parts, since
# one gloo connection moves a host buffer at a fraction of what several
# do on a host of several cores; and the size from which it splits.
# With these lanes and gathers run as all-reduces, a 2-rank mesh step of
# 6-layer GPT-2 small took 1.2 s on an NVIDIA H100 80GB HBM3 host, and
# 2.3 s with one group a collective and ``dist.all_gather`` (gathers 2.5x
# and all-reduces 1.5x slower; scripts/sweep_torch_mesh_lr.py
# --collectives, PERF.md section 6)
LANES = 4
LANE_BYTES = 1 << 22


class Mesh:
    """The ranks ``0..prod(shape)-1`` laid out row-major over ``axes``.

    ``shape`` maps each axis to its size and ``axis_names`` keeps their
    order, as on a JAX mesh. :func:`make_mesh` gives it, for each tuple
    of axes (in mesh order), the process group of this rank's peers over
    those axes; a mesh without groups still answers the shape questions
    (``axis_size``, ``index``). ``staged`` counts, per collective, its
    calls, the bytes this rank staged into it through host memory, and
    the seconds it took (the device-to-host copy included)."""

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
        # the LANES groups of each combination of axes (the first is
        # ``_groups``' own)
        self._lanes: Dict[Tuple[str, ...], list] = {}
        # per collective: [calls, bytes this rank staged into it, seconds]
        self.staged: Dict[str, list] = {}

    def _staged(self, name: str, nbytes: int, t0: float) -> None:
        rec = self.staged.setdefault(name, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += int(nbytes)
        rec[2] += time.perf_counter() - t0

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

    def _all_reduce_host(self, h: torch.Tensor, axes: Axes,
                         op: str = "sum") -> None:
        """All-reduce the contiguous host tensor ``h`` in place; from
        ``LANE_BYTES`` on, in equal parts on the axes' lanes at once (an
        element's reduction is the same whatever part holds it)."""
        import torch.distributed as dist
        op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        lanes = self._lanes.get(self._axes(axes), [])
        if h.nbytes < LANE_BYTES or len(lanes) < 2:
            dist.all_reduce(h, op=op, group=self.group(axes))
            return
        works = [dist.all_reduce(part, op=op, group=g, async_op=True)
                 for part, g in zip(h.view(-1).chunk(len(lanes)), lanes)]
        for w in works:
            w.wait()

    # -- collectives, through host memory ------------------------------
    def all_reduce(self, t: torch.Tensor, axes: Axes = None,
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``) or the maximum (``op="max"``) of ``t``
        over the shards of ``axes``, on ``t``'s device, the same bits on
        every rank."""
        t0 = time.perf_counter()
        h = t.detach().to("cpu", copy=True).contiguous()
        self._all_reduce_host(h, axes, op)
        out = h.to(t.device)
        self._staged("all_reduce", h.nbytes, t0)
        return out

    def any(self, flag: bool, axes: Axes = None) -> bool:
        """Whether ``flag`` is true on any shard of ``axes``."""
        return bool(self.all_reduce(torch.tensor([int(flag)]), axes)[0])

    def all_gather(self, a: np.ndarray, axes: Axes = None) -> np.ndarray:
        """Every shard's host array ``a`` (same shape and dtype on every
        shard), concatenated along axis 0 in shard order, bit for bit.

        It runs as one all-reduce: each shard writes its bytes into its
        own slot of a zeroed buffer, viewed as integers, and the sum
        leaves every slot its owner's bits (the others add zeros; split
        over the ``LANES``, 2.5x faster than gloo's all-gather on one
        group)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        a = np.ascontiguousarray(a)
        raw = a.reshape(-1).view(np.uint8)
        if raw.size % 4 == 0:
            raw = raw.view(np.int32)
        group = self.group(axes)
        n = dist.get_world_size(group)
        buf = torch.zeros(n * raw.size, dtype=torch.from_numpy(raw).dtype)
        me = self.index(axes)
        buf[me * raw.size:(me + 1) * raw.size] = torch.from_numpy(raw)
        self._all_reduce_host(buf, axes)
        out = buf.numpy().view(a.dtype).reshape((n * a.shape[0],)
                                                + a.shape[1:])
        self._staged("all_gather", a.nbytes, t0)
        return out

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
    of every combination of axes (the whole world for all of them), and
    ``LANES - 1`` more of each for the split all-reduce."""
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
                mesh._lanes[key] = [dist.group.WORLD] + [
                    dist.new_group(list(range(mesh.size)))
                    for _ in range(LANES - 1)]
                continue
            # one group per setting of the other axes, created in the
            # same order on every rank; this rank keeps its own
            rest = [i for i in range(len(axes)) if i not in sub]
            moved = np.moveaxis(grid, rest, range(len(rest)))
            for ranks in moved.reshape(-1, int(np.prod(
                    [dims[i] for i in sub]))):
                lanes = [dist.new_group([int(r) for r in ranks])
                         for _ in range(LANES)]
                if mesh.rank in ranks:
                    mesh._groups[key] = lanes[0]
                    mesh._lanes[key] = lanes
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


def batch_axes(mesh: Mesh, mc_or_data_axes, batch: int):
    """The data axes a batch of ``batch`` rows shards over: all of them
    when they divide it, else the first alone, else None.
    ``mc_or_data_axes`` is a :class:`MeshConfig` (its ``data_axes``, as
    the reference takes it) or the data axes themselves."""
    axes = tuple(mc_or_data_axes.data_axes
                 if isinstance(mc_or_data_axes, MeshConfig)
                 else mc_or_data_axes)
    if batch % axis_size(mesh, axes) == 0:
        return axes
    for sub in (axes[:1], ()):
        if not sub or batch % axis_size(mesh, sub) == 0:
            return sub or None
    return None


# ----------------------------------------------------------------------
# the partition-spec half: logical axis names -> mesh axes
# ----------------------------------------------------------------------

def make_mesh_from_config(mc: MeshConfig) -> Mesh:
    return make_mesh(mc.shape, mc.axes)


def mesh_config_for(mesh: Mesh, **kw) -> MeshConfig:
    """A MeshConfig matching an existing mesh: pure FSDP when the mesh
    has no "model" axis (small-model data-parallel training), the
    default TP + FSDP profile otherwise. ``kw`` overrides profile
    knobs."""
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    kw.setdefault(
        "profile",
        "tp_fsdp" if "model" in mesh.axis_names else "pure_fsdp")
    return MeshConfig(shape=shape, axes=tuple(mesh.axis_names), **kw)


# the default profile: Megatron-style TP over "model" for heads, kv, mlp,
# experts and vocab, and FSDP over the data axes on every weight's embed
# dimension (ZeRO-3)
_TP_RULES = {None: None, "layers": None, "vocab": "model",
             "heads": "model", "kv": "model", "mlp": "model",
             "ssm": "model", "ssm_heads": "model", "experts": "model",
             "mlp_noshard": None}


def logical_to_pspec(spec: Sequence, shape: Sequence[int], mesh: Mesh,
                     mc: MeshConfig) -> Tuple:
    """Map one leaf's logical axis names to a spec. A logical axis whose
    size does not divide its mesh axes falls back to replication."""
    fsdp_axes = tuple(mc.data_axes) if mc.fsdp else None
    if mc.profile == "pure_fsdp":
        # no tensor parallelism: everything replicated except the FSDP
        # (embed) axis, which shards over the whole mesh
        rules: Dict[Optional[str], Any] = {"embed": fsdp_axes}
    else:
        rules = dict(_TP_RULES, embed=fsdp_axes)
    out = []
    for dim, name in zip(shape, spec):
        axes = rules.get(name, None)
        if axes is not None and dim % axis_size(mesh, axes) != 0:
            axes = None  # divisibility fallback: replicate
        out.append(axes)
    return pspec(*out)


def pspec(*entries) -> Tuple:
    """The port's counterpart of ``PartitionSpec(*entries)``, normalized
    as a ``PartitionSpec`` normalizes: a tuple of one name becomes the
    name, an empty tuple ``None``."""
    def one(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(one(e) for e in entries)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)


def param_shardings(mesh: Mesh, mc: MeshConfig, params, specs):
    """The spec of each leaf of ``params`` (tensors, arrays or shape
    tuples such as ``models.param_shapes``'s), from ``specs``, the tree
    of logical axis names that mirrors it down to its leaves
    (``models.model_specs``)."""
    if isinstance(params, dict):
        return {k: param_shardings(mesh, mc, v, specs[k])
                for k, v in params.items()}
    return logical_to_pspec(tuple(specs), _shape(params), mesh, mc)


def batch_sharding(mesh: Mesh, mc: MeshConfig, batch: int) -> Tuple:
    """The spec of a batch of ``batch`` rows: its rows over the data
    axes that divide them."""
    return pspec(batch_axes(mesh, mc, batch))


def _first_fit(mesh: Mesh, axis: str, dims, candidates):
    """The first dim index (of ``candidates``) that ``axis`` divides."""
    n = mesh.shape[axis]
    for i in candidates:
        if dims[i] % n == 0 and dims[i] >= n:
            return i
    return None


def cache_shardings(cfg, mesh: Mesh, mc: MeshConfig, cache):
    """Decode-cache specs: the batch over the data axes; a KV cache's
    sequence over "model" (context-parallel decode) when divisible, else
    its heads or head dim. ``cache`` is a tree (dicts, lists, tuples) of
    leaves with a ``shape``."""
    def shard_leaf(leaf):
        dims = tuple(leaf.shape)
        spec = [None] * len(dims)
        if len(dims) >= 2:
            # dim 0 is layers (or a scalar position); dim 1 is the batch
            ba = batch_axes(mesh, mc, dims[1])
            if ba:
                spec[1] = ba
        if len(dims) == 5:  # KV (L, B, S, H, D) or SSM state (L, B, H, P, N)
            if mc.seq_shard_kv:
                i = _first_fit(mesh, "model", dims, (2, 3))
            else:
                i = _first_fit(mesh, "model", dims, (3, 2))
            if i is None:
                i = _first_fit(mesh, "model", dims, (4,))
            if i is not None:
                spec[i] = "model"
        elif len(dims) == 4:  # SSM conv cache (L, B, K-1, C)
            i = _first_fit(mesh, "model", dims, (3,))
            if i is not None:
                spec[i] = "model"
        return pspec(*spec)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            return type(node)(walk(v) for v in node)
        return shard_leaf(node)

    return walk(cache)


# ----------------------------------------------------------------------
# a rank's slice of a tensor, and the whole from every rank's slice
# ----------------------------------------------------------------------

def _sharded_dims(spec, ndim: int):
    """(dim, axes) of each sharded dim of a spec."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"tensor's {ndim} dims")
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def shard_of(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``spec``: along
    each sharded dim, the ``mesh.index(axes)``-th of
    ``axis_size(mesh, axes)`` equal chunks (a view of ``t``)."""
    for d, axes in _sharded_dims(spec, t.dim()):
        n = axis_size(mesh, axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of size {t.shape[d]} does not split "
                             f"into {n} shards over {axes}")
        size = t.shape[d] // n
        t = t.narrow(d, mesh.index(axes) * size, size)
    return t


def gather_shards(shard: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_of`` slice, on
    ``shard``'s device, the same bits on every rank (one
    ``Mesh.all_gather`` a sharded dim; a collective: every rank of the
    spec's axes calls it)."""
    out = shard
    for d, axes in reversed(_sharded_dims(spec, shard.dim())):
        h = out.detach().to("cpu").contiguous()
        raw = h.view(torch.int16) if h.dtype == torch.bfloat16 else h
        parts = torch.from_numpy(mesh.all_gather(raw.numpy()[None], axes))
        parts = parts.to(shard.device).view(h.dtype)  # (n, *slice shape)
        # the n slices side by side along d, laid out on the device
        shape = list(out.shape)
        shape[d] *= parts.shape[0]
        out = parts.movedim(0, d).reshape(shape)
    return out.contiguous()


def _is_spec(node) -> bool:
    return isinstance(node, tuple) and not hasattr(node, "_fields")


def _map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and named tuples (such as
    a ``TrainState``) whose spec tree mirrors it down to its leaves;
    ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_specs(fn, v, s)
                            for v, s in zip(tree, specs)))
    if not _is_spec(specs):
        raise ValueError(f"no spec for a leaf: got {specs!r}")
    return fn(tree, specs)


def shard_tree(tree, specs, mesh: Mesh):
    """Each leaf's :func:`shard_of` slice, copied (so the whole leaves
    can be freed)."""
    return _map_with_specs(lambda t, s: shard_of(t, s, mesh).clone(), tree,
                           specs)


def gather_tree(tree, specs, mesh: Mesh):
    """Each leaf whole again (:func:`gather_shards`, one collective a
    sharded leaf, in the tree's order on every rank)."""
    return _map_with_specs(lambda t, s: gather_shards(t, s, mesh), tree,
                           specs)
