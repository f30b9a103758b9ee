"""Gradual ZipLM's glue between pruning and finetuning.

For now this holds the finetuning masks only; the reference's family
engine (``gradual_prune``, the resumable ``FamilyRunState`` manifest and
its stage artifacts) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..optim.adamw import tree_leaves, tree_map
from .structures import UNITS


def masks_from_assignment(cfg, params, db, assignment):
    """Params-shaped {0,1} fp32 mask tree, on the params' device, pinning
    pruned structures to zero during finetuning (gradients would otherwise
    regrow them). Only the out-side matrix rows of a removed structure are
    masked, as in the reference."""
    dev = tree_leaves(params)[0].device
    masks = tree_map(lambda p: torch.ones(p.shape, dtype=torch.float32,
                                          device=dev), params)
    for name, removed in assignment.items():
        mdb = db[name]
        mod = mdb.mod
        gs = mod.group_size
        row_mask = np.zeros(mod.d_in, np.float32)
        for g in mdb.kept_structures(removed):
            row_mask[g * gs:(g + 1) * gs] = 1.0
        rm = torch.from_numpy(row_mask)[:, None].to(dev)
        UNITS[mod.kind].mask_rows(masks["layers"], mod, rm)
    return masks
