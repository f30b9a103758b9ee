"""Shrink: materialise a ZipLM assignment as a physically smaller model.

Row structures zeroed in the out-side matrix leave their twin weights
dead; which twins die with which structures is each kind's
``PruneUnit.shrink_layer`` (``core.structures``):

  * attn: removed KV groups -> slice q/k/v projection columns + wo rows
  * ssm:  removed SSD heads -> slice in_z/in_x/conv_x/norm columns and
          in_dt/A_log/D/dt_bias entries + out_proj rows (B/C kept whole)
  * moe:  per expert as ffn; a fully dropped expert keeps its router
          column (top-k routing must match the masked model's) but
          carries no weights and costs no FLOPs
  * ffn:  removed FC2 rows  -> slice wg/wu (or wi/bi) columns + wd rows

A layer whose every unit sits at its full-drop level shrinks to an empty
``PrunedLayer``: the pruned forward passes straight through it (and
``init_cache_pruned`` gives it no KV cache), adding only a GELU FFN's
output bias ``bd``, which the masked model's emptied FFN still adds (the
reference drops it; a finetune makes it nonzero). The shrunk model gives
the masked model's outputs; only the compute gets smaller.

``shrink`` and ``shrink_from_stitched`` are one driver over two weight
sources: a host context (numpy indexing over params and the database's
snapshots, the result moved to ``device``) and a device context
(``torch.index_select`` over a ``SnapshotCache.apply`` stitched tree, for
a family server that must not pull params off the card). Both give equal
``PrunedModel``s.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models.pruned import (PrunedLayer, PrunedModel,
                             refuse_cross_attention)
from ..runtime.device import DeviceLike, resolve_device
from .database import ModuleDB
from .structures import UNITS, dropped_layers


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


EXPERT_LEAVES = ("wg", "wu", "wd")  # an MoE layer's (L, E, ...) leaves


class _HostCtx:
    """Weight source of ``shrink``: params and database snapshots sliced
    in host numpy (out-side matrices come from ``mdb.weights_at``), each
    result moved to ``device``."""

    def __init__(self, layers, db, assignment, device):
        self.layers = layers
        self.db = db
        self.assignment = assignment
        self.device = device

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def take(self, a, idx, axis):
        return self._dev(np.take(a, np.asarray(idx), axis=axis))

    def arr(self, a):
        return self._dev(a)

    def out_mat(self, mdb, removed, leaf):
        return np.asarray(mdb.weights_at(removed)).astype(np.float32)

    def layer_params(self, grp, l):
        return {k: _host(v[l]) for k, v in self.layers[grp].items()}

    def at_layer(self, grp, l):
        return {k: self._dev(_host(v[l]))
                for k, v in self.layers[grp].items()}

    def layer_leaf(self, grp, key, l):
        return self._dev(_host(self.layers[grp][key][l]))

    def expert_params(self, grp, l, e):
        return {k: _host(self.layers[grp][k][l, e]) for k in EXPERT_LEAVES}


class _DeviceCtx:
    """Weight source of ``shrink_from_stitched``: the stitched tree's
    out-side matrices already hold the per-level snapshots, so every slice
    is an ``index_select`` where the tree lives, with no host round trip."""

    def __init__(self, layers, db, assignment):
        self.layers = layers
        self.db = db
        self.assignment = assignment

    def take(self, a, idx, axis):
        return torch.index_select(
            a, axis, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                     device=a.device))

    def arr(self, a):
        return a

    def out_mat(self, mdb, removed, leaf):
        return leaf.float()

    def layer_params(self, grp, l):
        return {k: v[l] for k, v in self.layers[grp].items()}

    def at_layer(self, grp, l):
        return self.layer_params(grp, l)

    def layer_leaf(self, grp, key, l):
        return self.layers[grp][key][l]

    def expert_params(self, grp, l, e):
        return {k: self.layers[grp][k][l, e] for k in EXPERT_LEAVES}


def _shrink_impl(cfg, tree, ctx, device) -> PrunedModel:
    out_layers: List[PrunedLayer] = []
    for l in range(cfg.num_layers):
        lcfg = PrunedLayer()
        lp: Dict = {}
        for unit in UNITS.values():
            unit.shrink_layer(cfg, ctx, l, lcfg, lp)
        lcfg.params = lp
        out_layers.append(lcfg)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return node.to(device)

    globals_ = {"embed": move(tree["embed"]),
                "final_norm": move(tree["final_norm"])}
    if tree.get("head"):
        globals_["head"] = move(tree["head"])
    return PrunedModel(cfg=cfg, layers=out_layers, globals_=globals_)


def shrink(cfg, params, db: Dict[str, ModuleDB], assignment: Dict[str, int],
           device: DeviceLike = None) -> PrunedModel:
    """The shrunk model of ``assignment``, sliced on the host from
    ``params`` and the database's snapshots, on ``device``."""
    refuse_cross_attention(cfg, "shrink")
    dev = resolve_device(device)
    ctx = _HostCtx(params["layers"], db, assignment, dev)
    return _shrink_impl(cfg, params, ctx, dev)


def shrink_from_stitched(cfg, stitched, db: Dict[str, ModuleDB],
                         assignment: Dict[str, int]) -> PrunedModel:
    """The shrunk model of ``assignment`` from a ``SnapshotCache.apply``
    stitched tree, sliced where the tree lives (no host round trip). Gives
    the same ``PrunedModel`` as ``shrink``."""
    refuse_cross_attention(cfg, "shrink_from_stitched")
    dev = stitched["embed"]["table"].device
    ctx = _DeviceCtx(stitched["layers"], db, assignment)
    return _shrink_impl(cfg, stitched, ctx, dev)


def kv_cache_plan(cfg, db: Dict[str, ModuleDB],
                  assignment: Dict[str, int]) -> List[int]:
    """Per-layer KV-head counts the shrunk model needs when served; 0 means
    the layer's attention module (or the whole layer) is gone and gets no
    cache at all. Feed it to ``transformer.init_cache(kv_heads=...)``, or
    let ``models.pruned.init_cache_pruned`` derive it."""
    return [sum(u.kv_heads(cfg, db, assignment, l) for u in UNITS.values())
            for l in range(cfg.num_layers)]


def layer_drop_plan(cfg, assignment: Dict[str, int]) -> List[bool]:
    """Per-layer whole-layer-drop flags: True iff every prunable unit of
    the layer sits at its full-drop level (the shrunk model passes
    straight through it)."""
    return dropped_layers(cfg, assignment)
