"""Data-parallel ranks over ``torch.distributed``: named mesh axes, their
collectives and the data-axis helpers (``sharding``), and the ambient
mesh context (``activation``). The processes come from
``launch.subproc.run_ranks``."""
from .activation import (activation_context, clear_activation_context,
                         get_activation_context, set_activation_context)
from .sharding import (Mesh, axis_size, batch_axes, data_axes_for,
                       make_mesh, pad_leading)

__all__ = ["Mesh", "activation_context", "axis_size", "batch_axes",
           "clear_activation_context", "data_axes_for",
           "get_activation_context", "make_mesh", "pad_leading",
           "set_activation_context"]
