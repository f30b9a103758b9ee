"""The ambient (mesh, batch axes) context of the JAX package's
``distributed/activation.py``.

A launcher installs it, and calibration (``core.hessian.collect_hessians``)
and ``core.oneshot.oneshot_prune`` discover the mesh from it when the
caller passes none. Contexts nest: :class:`activation_context` restores
whatever was installed before.

``constrain_batch`` is not ported, and no stand-in for it is. In the
reference it pins a global-view array's batch dimension to the data axes
inside a traced forward; a port rank holds only its own rows, so there
is nothing to pin, and no caller of the sharded calibration or database
needs it.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

_ctx = threading.local()


def set_activation_context(mesh, batch_axes) -> None:
    _ctx.mesh = mesh
    _ctx.batch_axes = batch_axes


def clear_activation_context() -> None:
    _ctx.mesh = None
    _ctx.batch_axes = None


def get_activation_context() -> Tuple[Optional[object], Optional[Tuple]]:
    """The installed (mesh, batch_axes), or (None, None) outside a
    context."""
    return getattr(_ctx, "mesh", None), getattr(_ctx, "batch_axes", None)


class activation_context:
    """Install (mesh, batch_axes); on exit restore whatever was installed
    before."""

    def __init__(self, mesh, batch_axes):
        self.mesh, self.batch_axes = mesh, batch_axes

    def __enter__(self):
        self._prev = get_activation_context()
        set_activation_context(self.mesh, self.batch_axes)
        return self

    def __exit__(self, *a):
        set_activation_context(*self._prev)
        return False
