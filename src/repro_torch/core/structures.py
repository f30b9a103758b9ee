"""The ``PruneUnit`` protocol: every prunable structure kind, one contract.

A structure is a group of input rows (``y = x @ W``) of a projection that
feeds the residual stream. Each kind answers, through one ``PruneUnit``:
which forward capture feeds its Hessian (``get_capture``), where its
out-side matrix lives (``param_path``, ``get_matrix``/``set_matrix``),
its level grid in structures removed (``grid``; every grid ends at the
full module drop), and what a level costs (``cost_time`` for the
analytic model, ``timing_spec`` for the measured backend).

The port has the two units of dense models:

  * ``attn`` — ``W_o``, one group per KV head (q_per_kv query heads x
    head_dim rows);
  * ``ffn`` — ``W_down``, single-row groups.

MoE experts, SSM heads, shrinking and the KV-cache plan are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime import costmodel as cm


@dataclass(frozen=True)
class PrunableModule:
    name: str                 # "L{layer}.{kind}"
    kind: str                 # attn | ffn
    layer: int
    expert: int = -1
    weight_key: str = ""      # leaf name of the out-side matrix ("wo"/"wd")
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

    def layer_modules(self, cfg, layer: int) -> List[PrunableModule]:
        raise NotImplementedError

    def get_matrix(self, params, mod: PrunableModule) -> torch.Tensor:
        grp, leaf = self.param_path
        return params["layers"][grp][leaf][mod.layer]

    def set_matrix(self, layers, mod: PrunableModule, w) -> None:
        """Replace one layer's matrix in a copy of the leaf (the caller's
        tree is never written)."""
        grp, leaf = self.param_path
        new = layers[grp][leaf].clone()
        new[mod.layer] = w.to(device=new.device, dtype=new.dtype)
        layers[grp][leaf] = new

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


# kind -> singleton; iteration order is the within-layer registry order
UNITS: Dict[str, PruneUnit] = {u.kind: u for u in (AttnUnit(), FfnUnit())}


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


def get_capture(captures: Dict, mod: PrunableModule):
    """The calibration inputs (X (N, d_in), valid) of a module, from
    forward captures stacked over layers."""
    layer_caps = {g: {k: v[mod.layer] for k, v in sub.items()}
                  for g, sub in captures.items()}
    return UNITS[mod.kind].get_capture(layer_caps, mod)


def level_grid(mod: PrunableModule, steps: int = 43) -> List[int]:
    """Sparsity levels as 'structures removed' counts (see PruneUnit.grid)."""
    return UNITS[mod.kind].grid(mod, steps)
