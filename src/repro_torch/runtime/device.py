"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and asking for CUDA on a machine
without it raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

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


def device_key(device: Union[str, torch.device]) -> torch.device:
    """One name for each device (a bare ``"cuda"`` is the current card,
    and every ``"cpu:i"`` the CPU), so that two names of one device
    compare equal."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def placement_streams(devices: Sequence) -> List[Optional["torch.cuda.Stream"]]:
    """A new CUDA stream for each entry of ``devices`` that names a CUDA
    device (None for any other entry), each made to wait for the work
    queued so far on its device's current stream, so that work queued on
    it sees the caller's. Run work on one with ``torch.cuda.stream(s)``
    (a no-op for None), and end with :func:`join_streams`."""
    out = []
    for d in devices:
        dev = (torch.device(d) if isinstance(d, (str, torch.device))
               else None)
        if dev is None or dev.type != "cuda":
            out.append(None)
            continue
        s = torch.cuda.Stream(device=dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        out.append(s)
    return out


def join_streams(streams: Sequence[Optional["torch.cuda.Stream"]]) -> None:
    """Make the current stream of each stream's device wait for it: work
    the caller queues next sees what was queued on the streams."""
    for s in streams:
        if s is not None:
            torch.cuda.current_stream(s.device).wait_stream(s)


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
