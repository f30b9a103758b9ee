"""The ``PruneUnit`` protocol: every prunable structure kind, one contract.

A structure is a group of input rows (``y = x @ W``) of a projection that
feeds the residual stream. Each kind answers, through one ``PruneUnit``:
which forward capture feeds its Hessian (``get_capture``), where its
out-side matrix lives (``param_path``, ``get_matrix``/``set_matrix``),
its level grid in structures removed (``grid``; every grid ends at the
full module drop), and what a level costs (``cost_time`` for the
analytic model, ``timing_spec`` for the measured backend).

The port has the reference's four units:

  * ``attn`` — ``W_o``, one group per KV head (q_per_kv query heads x
    head_dim rows);
  * ``ssm`` (Mamba-2/SSD) — ``out_proj``, one group per SSD head
    (ssm_head_dim rows); the in-projection, conv, A/D/dt and norm twins
    shrink with it;
  * ``moe`` — per-expert ``W_down`` rows, one module ``L{l}.expert{e}``
    per expert. ``cfg.moe_prune_unit`` sets the granularity: ``"width"``
    (default) prunes an expert's FFN width on the 0.9^i grid,
    ``"expert"`` pins each expert's grid to ``(0, d_ff)``, keep or drop
    the whole expert. A fully dropped expert keeps its router column
    (the masked and the shrunk model must route alike) but carries no
    weights and costs no FLOPs;
  * ``ffn`` — ``W_down``, single-row groups.

Each unit also says what it contributes to a layer's KV-cache plan
(``kv_heads``) and how it shrinks a layer (``shrink_layer``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime import costmodel as cm


@dataclass(frozen=True)
class PrunableModule:
    name: str                 # "L{layer}.{kind}" or "L{layer}.expert{e}"
    kind: str                 # attn | ssm | moe | ffn
    layer: int
    expert: int = -1          # >= 0 for per-expert modules
    weight_key: str = ""      # leaf name of the out-side matrix
    capture_key: str = ""     # capture feeding this matrix
    group_size: int = 1
    n_structures: int = 0
    levels: Optional[Tuple[int, ...]] = None  # pinned grid (None = default)

    @property
    def d_in(self) -> int:
        return self.group_size * self.n_structures


class PruneUnit:
    """One structure kind's contract with the pipeline. Stateless
    singletons in ``UNITS``; per-module facts travel in the
    :class:`PrunableModule`."""

    kind: str = ""
    param_path: Tuple[str, str] = ("", "")   # (group, leaf) under "layers"
    per_expert: bool = False                 # leaf carries an (L, E, ...) axis

    def layer_modules(self, cfg, layer: int) -> List[PrunableModule]:
        raise NotImplementedError

    def index(self, mod: PrunableModule):
        """The module's index into its stacked leaf."""
        return (mod.layer, mod.expert) if self.per_expert else mod.layer

    def get_matrix(self, params, mod: PrunableModule) -> torch.Tensor:
        grp, leaf = self.param_path
        return params["layers"][grp][leaf][self.index(mod)]

    def set_matrix(self, layers, mod: PrunableModule, w) -> None:
        """Replace one module's matrix in a copy of the leaf (the caller's
        tree is never written)."""
        grp, leaf = self.param_path
        new = layers[grp][leaf].clone()
        new[self.index(mod)] = w.to(device=new.device, dtype=new.dtype)
        layers[grp][leaf] = new

    def mask_rows(self, layers, mod: PrunableModule, row_mask) -> None:
        """Scale the out-side matrix rows in a params-shaped mask tree, in
        place (``row_mask``: (d_in, 1)). The tree is the caller's own mask
        tree, never a params tree (``core.pipeline.masks_from_assignment``)."""
        grp, leaf = self.param_path
        layers[grp][leaf][self.index(mod)] *= row_mask

    def get_capture(self, layer_caps, mod: PrunableModule):
        """(X, valid) for one layer's captures; X: (N, d_in)."""
        grp, _ = self.param_path
        x = layer_caps[grp][mod.capture_key]
        return x.reshape(-1, x.shape[-1]), None

    def grid(self, mod: PrunableModule, steps: int = 43) -> List[int]:
        """Sparsity levels as 'structures removed' counts, ascending;
        head-granular modules get 0..n, FFN-like modules the paper's
        Appendix E ceil(n * 0.9^i) sizes; the last level is always the
        full module drop."""
        if mod.levels is not None:
            return list(mod.levels)
        n = mod.n_structures
        if mod.group_size > 1 or n <= 64:
            return list(range(n + 1))
        sizes = sorted({int(np.ceil(n * 0.9 ** i)) for i in range(steps)}
                       | {0}, reverse=True)
        return [n - s for s in sizes]

    def cost_time(self, cfg, env, removed: int) -> float:
        raise NotImplementedError

    def timing_spec(self, cfg, env, removed: int) -> Optional[Dict]:
        """What the measured backend times at a level; None = nothing
        (the module is dropped)."""
        raise NotImplementedError

    # ---- serving ----
    def kv_heads(self, cfg, db, assignment, layer: int) -> int:
        """This unit's KV-head contribution to one layer's cache plan."""
        return 0

    # ---- shrink ----
    def shrink_layer(self, cfg, ctx, layer: int, lcfg, lp) -> None:
        """Materialise this unit's shrunk weights for one layer.

        ``ctx`` is the weight source (``core.shrink``: host numpy over
        params + database snapshots, or ``index_select`` over a stitched
        tree on the device). Writes the surviving twin-weight slices into
        ``lp`` and the structural counts onto ``lcfg`` (a
        ``models.pruned.PrunedLayer``).
        """
        raise NotImplementedError


def _rows_for_groups(kept: np.ndarray, gs: int) -> np.ndarray:
    """Row indices of the kept groups of ``gs`` consecutive rows."""
    return (kept[:, None] * gs + np.arange(gs)[None, :]).reshape(-1)


class AttnUnit(PruneUnit):
    kind = "attn"
    param_path = ("attn", "wo")

    def layer_modules(self, cfg, layer):
        if cfg.attention == "none" or cfg.family == "ssm":
            return []
        return [PrunableModule(
            name=f"L{layer}.attn", kind="attn", layer=layer,
            weight_key="wo", capture_key="wo_in",
            group_size=cfg.q_per_kv * cfg.resolved_head_dim,
            n_structures=cfg.num_kv_heads)]

    def cost_time(self, cfg, env, removed):
        return cm.attn_time(cfg, env, cfg.num_kv_heads - removed)

    def timing_spec(self, cfg, env, removed):
        groups = int(cfg.num_kv_heads - removed)
        if groups <= 0:
            return None
        return {"module": "attn", "groups": groups}

    def kv_heads(self, cfg, db, assignment, layer):
        name = f"L{layer}.attn"
        if name in assignment:
            return len(db[name].kept_structures(assignment[name]))
        return cfg.num_kv_heads if self.layer_modules(cfg, layer) else 0

    def shrink_layer(self, cfg, ctx, layer, lcfg, lp):
        name = f"L{layer}.attn"
        if name not in ctx.assignment:
            return
        mdb = ctx.db[name]
        removed = ctx.assignment[name]
        kept = mdb.kept_structures(removed)          # kv group ids
        lcfg.kv_groups = len(kept)
        if len(kept) == 0:
            return
        dh = cfg.resolved_head_dim
        q_rows = _rows_for_groups(kept, cfg.q_per_kv * dh)
        kv_rows = _rows_for_groups(kept, dh)
        ap = ctx.layer_params("attn", layer)
        new_attn = {
            "wq": ctx.take(ap["wq"], q_rows, 1),
            "wk": ctx.take(ap["wk"], kv_rows, 1),
            "wv": ctx.take(ap["wv"], kv_rows, 1),
            "wo": ctx.take(ctx.out_mat(mdb, removed, ap["wo"]), q_rows, 0),
        }
        if cfg.qkv_bias:
            new_attn["bq"] = ctx.take(ap["bq"], q_rows, 0)
            new_attn["bk"] = ctx.take(ap["bk"], kv_rows, 0)
            new_attn["bv"] = ctx.take(ap["bv"], kv_rows, 0)
        lp["attn"] = new_attn
        lp["ln1"] = ctx.at_layer("ln1", layer)


class SsmUnit(PruneUnit):
    kind = "ssm"
    param_path = ("ssm", "out_proj")

    def layer_modules(self, cfg, layer):
        if not cfg.ssm_state:
            return []
        return [PrunableModule(
            name=f"L{layer}.ssm", kind="ssm", layer=layer,
            weight_key="out_proj", capture_key="ssm_out_in",
            group_size=cfg.ssm_head_dim, n_structures=cfg.ssm_heads)]

    def get_capture(self, layer_caps, mod):
        x = layer_caps["ssm_out_in"]  # a layer-level capture
        return x.reshape(-1, x.shape[-1]), None

    def cost_time(self, cfg, env, removed):
        return cm.ssm_time(cfg, env, cfg.ssm_heads - removed)

    def timing_spec(self, cfg, env, removed):
        f_live = int(cfg.ssm_heads - removed) * cfg.ssm_head_dim
        if f_live <= 0:
            return None
        return {"module": "ffn", "f_live": f_live, "tokens": env.tokens}

    def shrink_layer(self, cfg, ctx, layer, lcfg, lp):
        name = f"L{layer}.ssm"
        if name not in ctx.assignment:
            return
        mdb = ctx.db[name]
        removed = ctx.assignment[name]
        kept = mdb.kept_structures(removed)          # ssd head ids
        lcfg.ssm_heads = len(kept)
        if len(kept) == 0:
            return
        rows = _rows_for_groups(kept, cfg.ssm_head_dim)  # within d_inner
        sp = ctx.layer_params("ssm", layer)
        lp["ssm"] = {
            "in_z": ctx.take(sp["in_z"], rows, 1),
            "in_x": ctx.take(sp["in_x"], rows, 1),
            "in_bc": ctx.arr(sp["in_bc"]),
            "in_dt": ctx.take(sp["in_dt"], kept, 1),
            "conv_x": ctx.take(sp["conv_x"], rows, 1),
            "conv_x_b": ctx.take(sp["conv_x_b"], rows, 0),
            "conv_bc": ctx.arr(sp["conv_bc"]),
            "conv_bc_b": ctx.arr(sp["conv_bc_b"]),
            "A_log": ctx.take(sp["A_log"], kept, 0),
            "D": ctx.take(sp["D"], kept, 0),
            "dt_bias": ctx.take(sp["dt_bias"], kept, 0),
            "norm": ctx.take(sp["norm"], rows, 0),
            "out_proj": ctx.take(ctx.out_mat(mdb, removed, sp["out_proj"]),
                                 rows, 0),
        }
        lp["ln1"] = ctx.at_layer("ln1", layer)


class MoeUnit(PruneUnit):
    kind = "moe"
    param_path = ("moe", "wd")
    per_expert = True

    def layer_modules(self, cfg, layer):
        if not cfg.num_experts:
            return []
        # whole-expert granularity: pin each expert's grid to keep-or-drop
        levels = ((0, cfg.d_ff)
                  if cfg.moe_prune_unit == "expert" else None)
        return [PrunableModule(
            name=f"L{layer}.expert{e}", kind="moe", layer=layer, expert=e,
            weight_key="wd", capture_key="wd_in", group_size=1,
            n_structures=cfg.d_ff, levels=levels)
            for e in range(cfg.num_experts)]

    def get_capture(self, layer_caps, mod):
        """The expert's dispatch slots (C, f) and which of them a token
        filled (the rest hold zeros and count for no sample)."""
        return (layer_caps["ffn"]["wd_in"][mod.expert],
                layer_caps["ffn"]["wd_valid"][mod.expert])

    def cost_time(self, cfg, env, removed):
        return cm.moe_expert_time(cfg, env, cfg.d_ff - removed)

    def timing_spec(self, cfg, env, removed):
        f_live = int(cfg.d_ff - removed)
        if f_live <= 0:
            return None
        tokens = max(8, int(env.tokens * cfg.num_experts_per_tok
                            / cfg.num_experts * 1.25))
        return {"module": "ffn", "f_live": f_live, "tokens": tokens}

    def shrink_layer(self, cfg, ctx, layer, lcfg, lp):
        if f"L{layer}.expert0" not in ctx.assignment:
            return
        experts = []
        for e in range(cfg.num_experts):
            name = f"L{layer}.expert{e}"
            mdb = ctx.db[name]
            removed = ctx.assignment[name]
            kept = mdb.kept_structures(removed)
            if len(kept) == 0:
                # a fully dropped expert stays visible to the router:
                # deleting its column would change which experts win the
                # top-k (and the weights' normalisation) against the
                # masked model; it carries no weights and no compute
                experts.append(None)
                lcfg.expert_ff.append(0)
                continue
            ep = ctx.expert_params("moe", layer, e)
            experts.append({
                "wg": ctx.take(ep["wg"], kept, 1),
                "wu": ctx.take(ep["wu"], kept, 1),
                "wd": ctx.take(ctx.out_mat(mdb, removed, ep["wd"]), kept, 0),
            })
            lcfg.expert_ff.append(len(kept))
        if any(ep is not None for ep in experts):
            lp["moe"] = {"router": ctx.layer_leaf("moe", "router", layer),
                         "experts": experts}
            lp["ln2"] = ctx.at_layer("ln2", layer)
        else:
            lcfg.expert_ff = []  # the whole MoE module dropped


class FfnUnit(PruneUnit):
    kind = "ffn"
    param_path = ("ffn", "wd")

    def layer_modules(self, cfg, layer):
        if cfg.num_experts or not cfg.d_ff:
            return []
        return [PrunableModule(
            name=f"L{layer}.ffn", kind="ffn", layer=layer,
            weight_key="wd", capture_key="wd_in", group_size=1,
            n_structures=cfg.d_ff)]

    def cost_time(self, cfg, env, removed):
        return cm.ffn_time(cfg, env, cfg.d_ff - removed)

    def timing_spec(self, cfg, env, removed):
        f_live = int(cfg.d_ff - removed)
        if f_live <= 0:
            return None
        return {"module": "ffn", "f_live": f_live, "tokens": env.tokens}

    def shrink_layer(self, cfg, ctx, layer, lcfg, lp):
        name = f"L{layer}.ffn"
        if name not in ctx.assignment:
            return
        mdb = ctx.db[name]
        removed = ctx.assignment[name]
        kept = mdb.kept_structures(removed)
        lcfg.d_ff = len(kept)
        fp = ctx.layer_params("ffn", layer)
        if len(kept) == 0:
            # the masked FFN's output is then its bias alone: keep it (the
            # reference drops it, which is exact only while it is 0)
            if "bd" in fp:
                lp["ffn"] = {"bd": ctx.arr(fp["bd"])}
            return
        wd = ctx.take(ctx.out_mat(mdb, removed, fp["wd"]), kept, 0)
        if "wg" in fp:
            lp["ffn"] = {"wg": ctx.take(fp["wg"], kept, 1),
                         "wu": ctx.take(fp["wu"], kept, 1),
                         "wd": wd}
        else:
            lp["ffn"] = {"wi": ctx.take(fp["wi"], kept, 1),
                         "bi": ctx.take(fp["bi"], kept, 0),
                         "wd": wd,
                         "bd": ctx.arr(fp["bd"])}
        lp["ln2"] = ctx.at_layer("ln2", layer)


# kind -> singleton; iteration order is the within-layer registry order
UNITS: Dict[str, PruneUnit] = {
    u.kind: u for u in (AttnUnit(), SsmUnit(), MoeUnit(), FfnUnit())}


def registry(cfg) -> List[PrunableModule]:
    """Enumerate prunable modules for a model config."""
    return [m for l in range(cfg.num_layers)
            for u in UNITS.values() for m in u.layer_modules(cfg, l)]


def get_matrix(cfg, params, mod: PrunableModule) -> torch.Tensor:
    """The (d_in, d_out) out-side matrix of a prunable module."""
    return UNITS[mod.kind].get_matrix(params, mod)


def copy_tree(tree):
    return {k: copy_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree


def set_matrix(cfg, params, mod: PrunableModule, w) -> Dict:
    """A new params tree with the module's out-side matrix replaced."""
    params = copy_tree(params)
    UNITS[mod.kind].set_matrix(params["layers"], mod, w)
    return params


def _at_layer(tree, layer: int):
    if isinstance(tree, dict):
        return {k: _at_layer(v, layer) for k, v in tree.items()}
    return tree[layer]


def get_capture(captures: Dict, mod: PrunableModule):
    """The calibration inputs (X (N, d_in), valid) of a module, from
    forward captures stacked over layers (nested per group, as
    ``captures["attn"]["wo_in"]``, or at the layer level, as
    ``captures["ssm_out_in"]``). ``valid`` is None, or for an expert the
    (N,) mask of its dispatch slots that a token filled."""
    return UNITS[mod.kind].get_capture(_at_layer(captures, mod.layer), mod)


def level_grid(mod: PrunableModule, steps: int = 43) -> List[int]:
    """Sparsity levels as 'structures removed' counts (see PruneUnit.grid)."""
    return UNITS[mod.kind].grid(mod, steps)


# ----------------------------------------------------------------------
# whole-layer dropping
# ----------------------------------------------------------------------

def drop_layer(assignment: Dict[str, int], mods: List[PrunableModule],
               layer: int) -> Dict[str, int]:
    """Copy of ``assignment`` with every module of ``layer`` at its full
    drop level, the coarsest point of every per-layer grid. The pruned
    runtime runs such a layer as an identity block, plus a GELU FFN's
    output bias."""
    a = dict(assignment)
    for m in mods:
        if m.layer == layer:
            a[m.name] = m.n_structures
    return a


def dropped_layers(cfg, assignment: Dict[str, int]) -> List[bool]:
    """Per-layer whole-layer-drop flags: True iff the layer has prunable
    modules and the assignment removes every structure of every one."""
    out = []
    for l in range(cfg.num_layers):
        lm = [m for u in UNITS.values() for m in u.layer_modules(cfg, l)]
        out.append(bool(lm) and all(
            assignment.get(m.name, 0) >= m.n_structures for m in lm))
    return out
