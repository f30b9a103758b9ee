"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and asking for CUDA on a machine
without it raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run its plain PyTorch path on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# elements a pinned staging buffer holds in to_host (256 MB of float16)
HOST_CHUNK = 1 << 27


def to_host(t: torch.Tensor, chunk: int = HOST_CHUNK) -> np.ndarray:
    """A numpy copy of ``t`` in host memory (the tensor's own memory on
    the CPU, as ``t.cpu().numpy()`` gives it).

    A CUDA tensor comes over through two pinned staging buffers, ``chunk``
    elements at a time: the card copies one chunk while the host copies
    the one before into the result. A copy straight into pageable memory
    runs at the host's page-fault rate, and the databases' snapshots are
    tens of GB. The copies queue on the current stream after the work
    that produced ``t``."""
    if t.device.type != "cuda":
        return t.detach().cpu().numpy()
    src = t.detach().contiguous().reshape(-1)
    n = src.numel()
    out = torch.empty(n, dtype=t.dtype)
    size = min(chunk, n)
    stage = [torch.empty(size, dtype=t.dtype, pin_memory=True)
             for _ in range(2 if n > chunk else 1)]
    ready = [torch.cuda.Event() for _ in stage]
    starts = list(range(0, n, chunk))

    def drain(j):
        k, i = j % len(stage), starts[j]
        m = min(chunk, n - i)
        ready[k].synchronize()
        out[i:i + m].copy_(stage[k][:m])

    for j, i in enumerate(starts):
        k = j % len(stage)
        if j >= len(stage):
            drain(j - len(stage))  # the chunk this buffer holds
        m = min(chunk, n - i)
        stage[k][:m].copy_(src[i:i + m], non_blocking=True)
        ready[k].record()
    for j in range(max(0, len(starts) - len(stage)), len(starts)):
        drain(j)
    return out.reshape(t.shape).numpy()
