"""Calibration Hessian accumulation ``X^T X`` (or ``acc + X^T X``) in fp32.

Replaces the TPU kernel ``src/repro/kernels/hessian_accum.py``
(``hessian_accum_kernel``). The CUDA kernel is ``csrc/hessian_accum.cu``;
its header says what bounds it on the card (fp32 FMA at the main path's
shapes) and what its design does about that: 128 x 128 upper tiles,
strips of X by ``cp.async`` and a deterministic split of the rows of X
over the blocks, planned here by ``split_plan``.

``hessian_accum`` launches the kernel for a CUDA tensor and uses the
plain PyTorch version only for a tensor on the CPU. It never falls back:
a kernel that cannot launch raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import torch

from . import build

TILE = 128         # output tile edge of the kernel
STRIP = 16         # rows of X a block stages at a time
MIN_SPLIT_ROWS = 8 * STRIP  # no split of N shorter than this
LAST_WAVE_FILL = 0.75       # the split rule's target for the last wave

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# entry name -> its index for hessian_accum_occupancy
_ENTRIES = {"hessian_accum_f32": 0, "hessian_accum_f32_unaligned": 1,
            "hessian_accum_bf16": 2}
_OCCUPANCY = "hessian_accum_occupancy"
_SIGNATURES = {**{e: _SIGNATURE for e in _ENTRIES},
               _OCCUPANCY: [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]}

# (entry, device index) -> blocks per SM; (tiles a side, device index) ->
# the upper tiles' (ti, tj) table on the card
_BLOCKS_PER_SM: Dict[Tuple[str, int], int] = {}
_TILE_TABLES: Dict[Tuple[int, int], torch.Tensor] = {}


@dataclass(frozen=True)
class SplitPlan:
    """How one call divides ``X^T X`` over blocks: every upper tile
    ``upper[t]`` (``ti <= tj``, in launch order) once for each split of
    the rows of X; split ``s`` takes rows ``[s * chunk, min(n, (s + 1) *
    chunk))``. Work item ``s * len(upper) + t`` is block ``s *
    len(upper) + t`` of the launch, so the blocks in flight share one
    split's rows."""
    n: int
    tiles: int
    upper: Tuple[Tuple[int, int], ...]
    splits: int
    chunk: int

    @property
    def items(self) -> int:
        return self.splits * len(self.upper)

    def rows(self) -> List[Tuple[int, int]]:
        return [(s * self.chunk, min(self.n, (s + 1) * self.chunk))
                for s in range(self.splits)]

    @property
    def workspace_shape(self) -> Optional[Tuple[int, int, int, int]]:
        """The partial tiles' shape, or None with one split (the kernel
        then writes the output directly)."""
        if self.splits == 1:
            return None
        return (self.splits, len(self.upper), TILE, TILE)


def last_wave_fill(items: int, slots: int) -> float:
    """Share of the ``slots`` (SMs x blocks per SM) that the last wave of
    ``items`` equal work items occupies."""
    waves = -(-items // slots)
    return (items - (waves - 1) * slots) / slots


@lru_cache(maxsize=64)
def split_plan(n: int, d: int, sms: int, blocks_per_sm: int) -> SplitPlan:
    """The smallest split of N whose last wave is at least
    ``LAST_WAVE_FILL`` full on ``sms`` SMs holding ``blocks_per_sm``
    blocks each; if none is, the split that fills it most (the fewest
    splits on a tie). A split takes a whole number of strips, and N is
    split at most ``N // MIN_SPLIT_ROWS`` ways, so a short N is not."""
    tiles = max(1, -(-d // TILE))
    upper = tuple((i, j) for i in range(tiles) for j in range(i, tiles))
    strips = max(1, -(-n // STRIP))
    slots = sms * blocks_per_sm
    best, best_fill = (1, strips), -1.0
    for want in range(1, max(1, n // MIN_SPLIT_ROWS) + 1):
        chunk = -(-strips // want)
        splits = -(-strips // chunk)  # no empty split
        fill = last_wave_fill(splits * len(upper), slots)
        if fill > best_fill:
            best, best_fill = (splits, chunk), fill
        if fill >= LAST_WAVE_FILL:
            break
    splits, chunk = best
    return SplitPlan(n=n, tiles=tiles, upper=upper, splits=splits,
                     chunk=chunk * STRIP)


def hessian_accum_plain(x: torch.Tensor, acc: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(N, D) -> (D, D) fp32 ``X^T X``; ``acc + X^T X`` when acc is given."""
    xf = x.float()
    h = xf.T @ xf
    return h if acc is None else acc + h


def _entry(x: torch.Tensor) -> str:
    """The kernel variant for x: 16-byte copies where D % 4 == 0 and the
    base is 16-byte aligned, else 4-byte copies; bf16 its own."""
    if x.dtype == torch.bfloat16:
        return "hessian_accum_bf16"
    if x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0:
        return "hessian_accum_f32"
    return "hessian_accum_f32_unaligned"


def _blocks_per_sm(lib, entry: str, dev: torch.device) -> int:
    key = (entry, dev.index)
    if key not in _BLOCKS_PER_SM:
        blocks = ctypes.c_int(0)
        build.check(getattr(lib, _OCCUPANCY)(_ENTRIES[entry],
                                             ctypes.byref(blocks)),
                    "hessian_accum occupancy")
        _BLOCKS_PER_SM[key] = max(1, blocks.value)
    return _BLOCKS_PER_SM[key]


def launch_plan(x: torch.Tensor) -> Tuple[str, int, SplitPlan]:
    """For a CUDA tensor x: the kernel entry that takes it, that entry's
    blocks per SM on x's card, and the split plan of the call."""
    lib = build.load("hessian_accum", _SIGNATURES)
    entry = _entry(x)
    bps = _blocks_per_sm(lib, entry, x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return entry, bps, split_plan(x.shape[0], x.shape[1], sms, bps)


def _tile_table(plan: SplitPlan, dev: torch.device) -> torch.Tensor:
    key = (plan.tiles, dev.index)
    if key not in _TILE_TABLES:
        _TILE_TABLES[key] = torch.tensor(plan.upper, dtype=torch.int32,
                                         device=dev)
    return _TILE_TABLES[key]


def hessian_accum(x: torch.Tensor, acc: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(N, D) fp32/bf16 -> (D, D) fp32 ``X^T X``, or ``acc + X^T X`` in
    one pass when ``acc`` (D, D) fp32 is given. Counts its calls that
    launch the kernel in ``hessian_accum.launches`` (one per call, though
    a call with a split of N runs two CUDA kernels)."""
    build.dispatch()
    if x.device.type == "cpu":
        return hessian_accum_plain(x, acc)
    if x.device.type != "cuda":
        raise ValueError(f"hessian_accum: unsupported device {x.device}")
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError("hessian_accum: x must be a contiguous (N, D) fp32 "
                         f"or bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    if acc is not None and (acc.device != x.device
                            or acc.dtype != torch.float32
                            or tuple(acc.shape) != (d, d)
                            or not acc.is_contiguous()):
        raise ValueError("hessian_accum: acc must be a contiguous (D, D) "
                         "fp32 tensor on x's device")
    out = torch.empty((d, d), dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    entry, _, plan = launch_plan(x)
    ws = None if plan.workspace_shape is None else torch.empty(
        plan.workspace_shape, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(build.load("hessian_accum", _SIGNATURES), entry)(
        x.data_ptr(), acc.data_ptr() if acc is not None else None,
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        _tile_table(plan, x.device).data_ptr(), n, d, len(plan.upper),
        plan.splits, plan.chunk, stream)
    build.check(err, "hessian_accum")
    hessian_accum.launches += 1
    return out


hessian_accum.launches = 0
