"""The Mamba-2 SSD scan: the intra-chunk pass as a kernel, and the chunked
scan around it.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_intra_chunk_kernel``, body ``_ssd_kernel``), whose wrapper is
``kernels/ops.py`` ``ssd_chunked_kernel`` (``_ssd_chunked_impl``) and
whose oracle is ``kernels/ref.py`` ``ssd_ref``. The CUDA kernel is
``csrc/ssd_scan.cu``. Per (batch, chunk) and head it computes the scores
``C B^T``, the causal decay ``exp(segsum(dt A))``, ``y_diag`` and the
chunk's state. On the card the bytes bound it (255 MB against 8.1 GFLOP
at Mamba-2 2.7B's calibration shape); the kernel runs its three products
on the tensor cores (bf16 scores from bf16 B and C, split TF32 for every
fp32 operand), computes each chunk's scores once per block of heads and
keeps them out of device memory (its header has the reckoning).
``ssd_plan`` here decides the launch: the query tile, the heads a block
takes and the shared-memory layout.

``ssd_intra_chunk`` launches the kernel for CUDA tensors and uses the
plain PyTorch version only for tensors on the CPU. It never falls back:
inputs the kernel does not take, or a kernel that cannot launch, raise.

``ssd_chunked`` is the port of ``_ssd_chunked_impl`` with the model
twin's inputs (``models/ssm.py`` ``ssd_chunked``): it pads to whole
chunks (padded steps carry ``dt = 0`` and leave the state untouched),
forms the in-chunk cumulative sum and ``xdt`` as the model twin does
(``x * dt`` in x's type), runs the intra-chunk pass, scans the chunk
states from ``initial_state`` (which the reference's Pallas wrapper
drops) and adds the ``y_off`` term.

bf16: the model twin computes the scores as a bf16 product, the kernel
in fp32 from the bf16 B and C; the plain version follows the model twin,
so kernel and plain version differ there by the scores' rounding. In
fp32 they compute the same function.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Iterator, Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 512

# the kernel's launch plan (csrc/ssd_scan.cu)
MAX_TILE = 128        # a chunk up to this many rows is one query tile
SPLIT_TILE = 64       # the query tile of a longer chunk
KEY_BLOCK = 64        # keys per block of the score pass
SLAB_ROW_BYTES = 272  # a padded row of 128 bf16 or 64 fp32 B/C columns
SCORE_TILE_BYTES = 512  # one 16 x 8 fp32 score tile in fragment order
SMEM_LIMIT = 232448   # shared memory a block can use on Hopper
BLOCK_SETUP = 0.5     # a block's fixed cost (scores, first copies), in heads

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 7 + [_I] * 13 + [_P]
_ENTRIES = {torch.float32: "ssd_intra_chunk_f32",
            torch.bfloat16: "ssd_intra_chunk_bf16"}
_OCCUPANCY = "ssd_intra_chunk_occupancy"
_SIGNATURES = {**{e: _SIGNATURE for e in _ENTRIES.values()},
               _OCCUPANCY: [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]}
# (bf16 B/C, p, smem bytes, device index) -> blocks per SM
_BLOCKS_PER_SM: Dict[Tuple[bool, int, int, int], int] = {}


def _align16(x: int) -> int:
    return -(-x // 16) * 16


@dataclass(frozen=True)
class SsdLayout:
    """A block's query tile and shared memory, in bytes from its start:
    two xdt stages (``qt`` rows of ``p + 4`` floats; the score pass stages
    C and B rows there first), the score tiles, the B rows of the tile,
    two buffers of a head's dacs and the decay of the tile's rows."""
    qt: int
    tiles: int
    off_s: int
    off_b: int
    off_dac: int
    off_dec: int
    smem: int


@lru_cache(maxsize=256)
def ssd_layout(q: int, p: int) -> SsdLayout:
    """A chunk of ``q`` rows up to ``MAX_TILE`` is one query tile, padded
    to 16 rows; a longer one is cut into tiles of ``SPLIT_TILE`` rows. The
    score tiles are the last query tile's: 16-row slice ``r`` of a tile at
    row ``i0`` sees ``i0 / 8 + 2 (r + 1)`` tiles of 8 keys."""
    qt = _align16(q) if q <= MAX_TILE else SPLIT_TILE
    tiles = -(-q // qt)
    r = qt // 16
    i0 = (tiles - 1) * qt
    stages = max(2 * qt * (p + 4) * 4, (qt + KEY_BLOCK) * SLAB_ROW_BYTES)
    off_s = _align16(stages)
    off_b = off_s + (r * (i0 // 8) + r * (r + 1)) * SCORE_TILE_BYTES
    off_dac = off_b + qt * SLAB_ROW_BYTES
    off_dec = off_dac + 2 * (tiles * qt + 4) * 4
    return SsdLayout(qt=qt, tiles=tiles, off_s=off_s, off_b=off_b,
                     off_dac=off_dac, off_dec=off_dec,
                     smem=off_dec + qt * 4)


@dataclass(frozen=True)
class SsdPlan:
    """One launch: ``tiles * bc * groups`` blocks, block ``k`` taking
    query tile ``tiles - 1 - k // (bc * groups)`` (the longest first) of
    chunk ``(k % (bc * groups)) // groups`` and head group ``k % groups``,
    which holds heads ``[g * h // groups, (g + 1) * h // groups)``."""
    bc: int
    h: int
    groups: int
    layout: SsdLayout
    sms: int
    blocks_per_sm: int

    @property
    def blocks(self) -> int:
        return self.layout.tiles * self.bc * self.groups

    def block_work(self, k: int) -> Tuple[int, int, int, int]:
        """(query tile, chunk, first head, end head) of block ``k``, as
        the kernel decodes its ``blockIdx.x``."""
        per_tile = self.bc * self.groups
        tile = self.layout.tiles - 1 - k // per_tile
        chunk, grp = divmod(k % per_tile, self.groups)
        return (tile, chunk, grp * self.h // self.groups,
                (grp + 1) * self.h // self.groups)

    def work(self) -> Iterator[Tuple[int, int, int, int]]:
        return (self.block_work(k) for k in range(self.blocks))


def waves(blocks: int, slots: int) -> int:
    return -(-blocks // slots)


@lru_cache(maxsize=256)
def ssd_plan(bc: int, q: int, h: int, p: int, sms: int,
             blocks_per_sm: int) -> SsdPlan:
    """The head groups per chunk whose waves on ``sms`` SMs holding
    ``blocks_per_sm`` blocks each, times the heads of the largest group
    plus ``BLOCK_SETUP``, is least (the fewest groups on a tie): a block
    computes its chunk's scores once and then its heads one after
    another, so fewer, longer blocks share the scores while more blocks
    fill the card."""
    layout = ssd_layout(q, p)
    slots = max(1, sms * blocks_per_sm)
    best, best_cost = 1, float("inf")
    for groups in range(1, h + 1):
        blocks = layout.tiles * bc * groups
        if blocks > 2 ** 31 - 1:
            break
        cost = waves(blocks, slots) * (BLOCK_SETUP + -(-h // groups))
        if cost < best_cost:
            best, best_cost = groups, cost
    return SsdPlan(bc=bc, h=h, groups=best, layout=layout, sms=sms,
                   blocks_per_sm=blocks_per_sm)


def ssd_intra_chunk_plain(xdt, dacs, B, C) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The twin of ``_ssd_kernel``: xdt (b, nc, q, h, p) fp32, dacs
    (b, nc, q, h) fp32, B/C (b, nc, q, n) -> (y_diag (b, nc, q, h, p),
    states (b, nc, h, p, n)) fp32. The scores are a product in B and C's
    type, as the model twin forms them."""
    q = xdt.shape[2]
    scores = torch.einsum("bcqn,bckn->bcqk", C, B).float()
    diff = dacs[:, :, :, None, :] - dacs[:, :, None, :, :]  # (b,nc,q,k,h)
    tril = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], diff, NEG_INF))
    y = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, L, xdt)
    decay_end = torch.exp(dacs[:, :, -1:, :] - dacs)        # (b,nc,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", B.float(), decay_end,
                          xdt)
    return y, states


def _check(xdt, dacs, B, C):
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: xdt must be a CUDA or CPU "
                         f"tensor, got {xdt.device}")
    if xdt.ndim != 5:
        raise ValueError(f"ssd_intra_chunk: xdt must be (b, nc, q, h, p), "
                         f"got {tuple(xdt.shape)}")
    b, nc, q, h, p = xdt.shape
    if xdt.dtype != torch.float32 or dacs.dtype != torch.float32:
        raise ValueError(f"ssd_intra_chunk: xdt and dacs must be float32, "
                         f"got {xdt.dtype} and {dacs.dtype}")
    if dacs.shape != (b, nc, q, h):
        raise ValueError(f"ssd_intra_chunk: dacs must be {(b, nc, q, h)}, "
                         f"got {tuple(dacs.shape)}")
    if B.ndim != 4 or B.shape[:3] != (b, nc, q) or C.shape != B.shape:
        raise ValueError(f"ssd_intra_chunk: B and C must be ({b}, {nc}, "
                         f"{q}, n), got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    if B.dtype not in _ENTRIES or C.dtype != B.dtype:
        raise ValueError(f"ssd_intra_chunk: B and C must both be float32 "
                         f"or bfloat16, got {B.dtype} and {C.dtype}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_intra_chunk: the head dim must be one of "
                         f"{HEAD_DIMS}, got {p}")
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(f"ssd_intra_chunk: the chunk must hold 1 to "
                         f"{MAX_CHUNK} steps (its score rows live in shared "
                         f"memory), got {q}")
    if b * nc >= 2 ** 31 or B.shape[3] == 0:
        raise ValueError(f"ssd_intra_chunk: b * nc must be below 2**31 and "
                         f"the state size positive, got {b * nc} and "
                         f"{B.shape[3]}")
    for name, t in (("xdt", xdt), ("dacs", dacs), ("B", B), ("C", C)):
        if t.device != xdt.device:
            raise ValueError(f"ssd_intra_chunk: {name} must be on "
                             f"{xdt.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk: {name} must be contiguous "
                             "(row-major)")


def _blocks_per_sm(lib, bf16: bool, p: int, smem: int,
                   dev: torch.device) -> int:
    key = (bf16, p, smem, dev.index)
    if key not in _BLOCKS_PER_SM:
        blocks = ctypes.c_int(0)
        build.check(getattr(lib, _OCCUPANCY)(int(bf16), p, smem,
                                             ctypes.byref(blocks)),
                    "ssd_intra_chunk occupancy")
        _BLOCKS_PER_SM[key] = max(1, blocks.value)
    return _BLOCKS_PER_SM[key]


def launch_plan(xdt: torch.Tensor, B: torch.Tensor) -> SsdPlan:
    """The plan of a call on CUDA tensors: ``ssd_plan`` on the card's SM
    count and the kernel's occupancy there."""
    b, nc, q, h, p = xdt.shape
    lib = build.load("ssd_scan", _SIGNATURES)
    smem = ssd_layout(q, p).smem
    bps = _blocks_per_sm(lib, B.dtype == torch.bfloat16, p, smem,
                         xdt.device)
    sms = torch.cuda.get_device_properties(xdt.device).multi_processor_count
    return ssd_plan(b * nc, q, h, p, sms, bps)


def ssd_intra_chunk(xdt, dacs, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk pass (see ``ssd_intra_chunk_plain`` for shapes).
    Counts its kernel launches in ``ssd_intra_chunk.launches`` (one per
    call, though a chunk above 128 rows also runs a reduction). The kernel
    has no backward: a launch with grad mode on and an input that requires
    grad raises (the plain version on the CPU stays differentiable)."""
    if xdt.device.type == "cpu":
        return ssd_intra_chunk_plain(xdt, dacs, B, C)
    build.check_no_grad("ssd_intra_chunk", xdt, dacs, B, C)
    _check(xdt, dacs, B, C)
    b, nc, q, h, p = xdt.shape
    n = B.shape[3]
    y = torch.empty_like(xdt)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=xdt.device)
    if xdt.numel() == 0:
        return y, states
    plan = launch_plan(xdt, B)
    lay = plan.layout
    ws = None if lay.tiles == 1 else torch.empty(
        (lay.tiles, b, nc, h, p, n), dtype=torch.float32, device=xdt.device)
    lib = build.load("ssd_scan", _SIGNATURES)
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = getattr(lib, _ENTRIES[B.dtype])(
        xdt.data_ptr(), dacs.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(),
        ws.data_ptr() if ws is not None else None, b * nc, q, h, p, n,
        lay.qt, lay.tiles, plan.groups, lay.smem, lay.off_s, lay.off_b,
        lay.off_dac, lay.off_dec, stream)
    build.check(err, "ssd_intra_chunk")
    ssd_intra_chunk.launches += 1
    return y, states


ssd_intra_chunk.launches = 0


def intra_chunk_inputs(x, dt, A, B, C, chunk: int):
    """The intra-chunk pass's inputs (xdt, dacs, B, C) of a chunked scan
    (shapes as in ``ssd_chunked``), padded to whole chunks."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    dtb = dt.reshape(b, nc, chunk, h).float()
    dacs = torch.cumsum(dtb * A, dim=2).contiguous()        # (b,nc,q,h)
    xdt = (x.reshape(b, nc, chunk, h, p) * dtb[..., None].to(x.dtype))
    return (xdt.float().contiguous(), dacs,
            B.reshape(b, nc, chunk, n).contiguous(),
            C.reshape(b, nc, chunk, n).contiguous())


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x (b, s, h, p), dt (b, s, h) (softplus'ed), A (h,),
    B/C (b, s, n) -> (y (b, s, h, p) in x's type, final_state
    (b, h, p, n) fp32). The intra-chunk pass is ``ssd_intra_chunk``: the
    kernel for CUDA tensors, its plain version on the CPU; on CUDA it
    raises where an input requires grad under grad mode (the kernel has no
    backward)."""
    if x.device.type != "cpu":
        build.check_no_grad("ssd_chunked", x, dt, A, B, C, initial_state)
    b, s, h, p = x.shape
    xdt, dacs, Bb, Cb = intra_chunk_inputs(x, dt, A, B, C, chunk)
    nc, n = xdt.shape[1], Bb.shape[-1]
    y_diag, states = ssd_intra_chunk(xdt, dacs, Bb, Cb)

    # inter-chunk recurrence, one chunk at a time
    chunk_decay = torch.exp(dacs[:, :, -1, :])               # (b,nc,h)
    prev = (initial_state.float() if initial_state is not None
            else torch.zeros((b, h, p, n), dtype=torch.float32,
                             device=x.device))
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev_states, dim=1)            # (b,nc,h,p,n)

    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cb.float(), prev_states,
                         torch.exp(dacs))
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), prev
