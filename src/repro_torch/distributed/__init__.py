"""Data-parallel ranks over ``torch.distributed``: named mesh axes, their
collectives, the data-axis helpers and the logical-axis rules that map
parameters onto a mesh (``sharding``), and the ambient mesh context
(``activation``). The processes come from ``launch.subproc.run_ranks``."""
from .activation import (activation_context, clear_activation_context,
                         get_activation_context, set_activation_context)
from .sharding import (Mesh, axis_size, batch_axes, batch_sharding,
                       cache_shardings, data_axes_for, gather_shards,
                       gather_tree, logical_to_pspec, make_mesh,
                       make_mesh_from_config, mesh_config_for, pad_leading,
                       param_shardings, pspec, shard_of, shard_tree)

__all__ = ["Mesh", "activation_context", "axis_size", "batch_axes",
           "batch_sharding", "cache_shardings", "clear_activation_context",
           "data_axes_for", "gather_shards", "gather_tree",
           "get_activation_context", "logical_to_pspec", "make_mesh",
           "make_mesh_from_config", "mesh_config_for", "pad_leading",
           "param_shardings", "pspec", "set_activation_context", "shard_of",
           "shard_tree"]
