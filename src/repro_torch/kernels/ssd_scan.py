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
It is differentiable: ``SsdIntraChunk`` takes its gradient with the
backward kernel ``csrc/ssd_scan_bwd.cu`` on CUDA tensors and with
``ssd_intra_chunk_backward_plain`` on the CPU. The reference has no
Pallas backward; it differentiates the model twin's jnp pass
(``models/ssm.py``), whose formula the plain backward writes out.

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
# the backward kernel (csrc/ssd_scan_bwd.cu): 17 tensors, its plan (an int
# array and its length), stream
BWD_WAVE = 132        # an H100's SMs: the plan's yardstick of a wave, a
                      # constant so that the plan (and the bits) depend on
                      # the shapes alone
BWD_SETUP = 0.5       # dx_pass's fixed cost a block (scores), in heads
DBC_TILE = 128        # rows and columns of a dbc_pass block's output tile
DBC_STAGE_BYTES = 128 * 36 * 4 + 32 * 136 * 4  # one stage of its ring
DBC_STAGES = 3
DBC_HPG = 16          # most heads of a dbc_pass group
_BWD_ENTRIES = {torch.float32: "ssd_intra_chunk_bwd_f32",
                torch.bfloat16: "ssd_intra_chunk_bwd_bf16"}
_BWD_SIGNATURES = {e: [_P] * 17 + [ctypes.POINTER(ctypes.c_int), _I, _P]
                   for e in _BWD_ENTRIES.values()}
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


def _launch_forward(xdt, dacs, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors (one launch, counted)."""
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


class SsdIntraChunk(torch.autograd.Function):
    """The intra-chunk pass with its gradient: the forward kernel and the
    backward kernel on CUDA tensors, the plain forward and
    ``ssd_intra_chunk_backward_plain`` on the CPU. Saves the inputs only
    (the backward forms the scores and decays again)."""

    @staticmethod
    def forward(ctx, xdt, dacs, B, C):
        ctx.save_for_backward(xdt, dacs, B, C)
        if xdt.device.type == "cpu":
            return ssd_intra_chunk_plain(xdt, dacs, B, C)
        return _launch_forward(xdt, dacs, B, C)

    @staticmethod
    def backward(ctx, dy, dstates):
        # autograd hands an output that took no part in the loss a zero
        # cotangent (it materializes the grads)
        return ssd_intra_chunk_backward(*ctx.saved_tensors, dy.contiguous(),
                                        dstates.contiguous())


def ssd_intra_chunk(xdt, dacs, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk pass (see ``ssd_intra_chunk_plain`` for shapes),
    differentiable through ``SsdIntraChunk``. Counts its forward kernel's
    launches in ``ssd_intra_chunk.launches`` (one per call on CUDA
    tensors, though a chunk above 128 rows also runs a reduction); the
    backward kernel counts its own in
    ``ssd_intra_chunk_backward.launches``."""
    build.dispatch()
    return SsdIntraChunk.apply(xdt, dacs, B, C)


ssd_intra_chunk.launches = 0


def ssd_intra_chunk_backward_plain(xdt, dacs, B, C, dy, dstates):
    """The gradient of the intra-chunk pass in plain PyTorch: (dxdt,
    ddacs) fp32 and (dB, dC) in B's type, from the forward's inputs and
    the cotangents dy (b, nc, q, h, p) and dstates (b, nc, h, p, n).

    Per (batch, chunk) and head, with S = C B^T formed from B and C in
    fp32 (as the forward kernel forms it), L[q, k] = exp(dacs[q] -
    dacs[k]) for q >= k (else 0), e[q] = exp(dacs[-1] - dacs[q]),
    G = dy xdt^T and W = B dstates^T:
    dxdt = (S o L)^T dy + e o W; dC = dS B and dB = dS^T C + sum_h
    (e o xdt) dstates, with dS = sum_h G o L; and with R = G o S o L,
    ddacs[q] = sum_k R[q, k] - sum_k R[k, q] - e[q] u[q], u[q] = sum_p
    xdt[q, p] W[q, p], plus sum_q e[q] u[q] at the chunk's last row."""
    q = xdt.shape[2]
    Bf, Cf = B.float(), C.float()
    S = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)
    diff = dacs[:, :, :, None, :] - dacs[:, :, None, :, :]  # (b,nc,q,k,h)
    tril = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], diff, NEG_INF))
    e = torch.exp(dacs[:, :, -1:, :] - dacs)                 # (b,nc,q,h)
    GL = torch.einsum("bcqhp,bckhp->bcqkh", dy, xdt) * L
    dS = GL.sum(-1)
    W = torch.einsum("bckn,bchpn->bckhp", Bf, dstates)
    dxdt = (torch.einsum("bcqk,bcqkh,bcqhp->bckhp", S, L, dy)
            + e[..., None] * W)
    dC = torch.einsum("bcqk,bckn->bcqn", dS, Bf)
    dB = (torch.einsum("bcqk,bcqn->bckn", dS, Cf)
          + torch.einsum("bckh,bckhp,bchpn->bckn", e, xdt, dstates))
    R = GL * S[..., None]
    eu = e * (xdt * W).sum(-1)                               # (b,nc,q,h)
    ddacs = R.sum(3) - R.sum(2) - eu
    ddacs = torch.cat([ddacs[:, :, :-1], ddacs[:, :, -1:]
                       + eu.sum(2, keepdim=True)], dim=2)
    return dxdt, ddacs, dB.to(B.dtype), dC.to(C.dtype)


@dataclass(frozen=True)
class BwdLayout:
    """dx_pass's tile and shared memory, in bytes from its start: the
    pair's S^T fragments (512 bytes each, lower-triangular ones only on
    the diagonal), B's rows of the key tile (``ns`` columns, a slab), a
    ring of ``slots`` slots of ``slot`` bytes (a head's dstates slab, xdt
    or dy; the score pass stages C's rows there first), two buffers of a
    head's dacs (the tile's queries, its keys, the chunk's last row), the
    keys' decays to the chunk's end, and the sums of R and u."""
    t: int
    tiles: int
    ns: int
    slots: int
    slot: int
    off_b: int
    off_ring: int
    off_dac: int
    off_dec: int
    off_red: int
    smem: int

    @property
    def pairs(self) -> int:
        return self.tiles * (self.tiles + 1) // 2


@lru_cache(maxsize=1024)
def bwd_layout(q: int, p: int, n: int, bf16: bool) -> BwdLayout:
    """The backward's tile: the chunk padded to 16 rows up to 128 rows (64
    at ``p`` = 128), else tiles of 64 rows. Within it the widest slab of
    state columns (128 bf16 or 64 fp32, at most ``n`` rounded up to a
    k-step), then 4 ring slots before 3, that fit ``SMEM_LIMIT``."""
    tmax = 64 if p == 128 else MAX_TILE
    kstep, cols, esize = (16, 128, 2) if bf16 else (8, 64, 4)
    t = _align16(q) if q <= tmax else SPLIT_TILE
    tiles, r = -(-q // t), t // 16
    frags = r * (r + 1) if tiles == 1 else 2 * r * r
    parts = 8 // ((r + 1) // 2)  # warps sharing a pair of key slices
    for ns in range(min(cols, -(-n // kstep) * kstep), 0, -kstep):
        b_bytes = t * (ns + (8 if bf16 else 4)) * esize
        slot = _align16(max(t * (p + 4) * 4, p * (ns + 4) * 4))
        for slots in (4, 3):
            off_b = frags * SCORE_TILE_BYTES
            off_ring = _align16(off_b + b_bytes)
            off_dac = off_ring + max(slots * slot, b_bytes)
            off_dec = off_dac + 2 * (2 * t + 4) * 4
            off_red = off_dec + t * 4
            smem = off_red + (r + 2 * parts + 1) * t * 4
            if smem <= SMEM_LIMIT:
                return BwdLayout(t=t, tiles=tiles, ns=ns, slots=slots,
                                 slot=slot, off_b=off_b, off_ring=off_ring,
                                 off_dac=off_dac, off_dec=off_dec,
                                 off_red=off_red, smem=smem)
    raise ValueError(f"ssd_intra_chunk_backward: no layout fits (q, p, n) = "
                     f"{(q, p, n)}")


@dataclass(frozen=True)
class BwdPlan:
    """The backward's launches. dx_pass: ``blocks`` blocks, block ``k``
    taking (chunk, query tile, key tile, first head, end head) =
    ``block_work(k)``, ``hg`` head groups a pair. dbc_pass: per chunk,
    128-row tile and 128-column tile, ``sg`` groups of whole heads for the
    states' share of dB, then one block for dC and one for dS^T C."""
    bc: int
    q: int
    h: int
    p: int
    n: int
    layout: BwdLayout
    hg: int
    sg: int

    @property
    def blocks(self) -> int:
        return self.bc * self.layout.pairs * self.hg

    def block_work(self, k: int) -> Tuple[int, int, int, int, int]:
        rest, grp = divmod(k, self.hg)
        chunk, pair = divmod(rest, self.layout.pairs)
        qt = 0
        while (qt + 1) * (qt + 2) // 2 <= pair:
            qt += 1
        return (chunk, qt, pair - qt * (qt + 1) // 2, grp * self.h // self.hg,
                (grp + 1) * self.h // self.hg)

    def work(self) -> Iterator[Tuple[int, int, int, int, int]]:
        return (self.block_work(k) for k in range(self.blocks))

    @property
    def dbc_tiles(self) -> int:
        """dbc_pass's output tiles a chunk."""
        return -(-self.q // DBC_TILE) * -(-self.n // DBC_TILE)

    @property
    def dbc_blocks(self) -> int:
        return (self.sg + 2) * self.bc * self.dbc_tiles

    @property
    def dbc_smem(self) -> int:
        return (DBC_STAGES * DBC_STAGE_BYTES
                + -(-self.h // self.sg) * DBC_TILE * 4)

    def args(self) -> Tuple[int, ...]:
        """The kernel's ``Plan``, field by field."""
        lay = self.layout
        return (self.bc, self.q, self.h, self.p, self.n, lay.t, lay.tiles,
                self.hg, self.sg, lay.ns, lay.slots, lay.smem, lay.off_b,
                lay.off_ring, lay.slot, lay.off_dac, lay.off_dec,
                lay.off_red, self.dbc_smem)


@lru_cache(maxsize=1024)
def bwd_plan(bc: int, q: int, h: int, p: int, n: int,
             bf16: bool = True) -> BwdPlan:
    """From the shapes alone, so a call's bits do not depend on the card.
    dx_pass's head groups: the count whose waves of ``BWD_WAVE`` blocks,
    times the largest group's heads plus ``BWD_SETUP``, is least (the
    fewest on a tie), as ``ssd_plan`` picks the forward's. dbc_pass's
    groups: about two waves of its heavy blocks, at most ``DBC_HPG`` heads
    a group. Each group's share of dS or dB goes to a workspace, and the
    shares are added in group order."""
    layout = bwd_layout(q, p, n, bf16)
    best, best_cost = 1, float("inf")
    for groups in range(1, h + 1):
        blocks = bc * layout.pairs * groups
        if blocks > 2 ** 31 - 1:
            break
        cost = waves(blocks, BWD_WAVE) * (BWD_SETUP + -(-h // groups))
        if cost < best_cost:
            best, best_cost = groups, cost
    units = bc * -(-q // DBC_TILE) * -(-n // DBC_TILE)
    sg = min(h, max(-(-h // DBC_HPG), 2 * BWD_WAVE // units))
    return BwdPlan(bc=bc, q=q, h=h, p=p, n=n, layout=layout, hg=best, sg=sg)


def _check_backward(xdt, dacs, B, C, dy, dstates):
    _check(xdt, dacs, B, C)
    b, nc, q, h, p = xdt.shape
    n = B.shape[3]
    for name, t, shape in (("dy", dy, (b, nc, q, h, p)),
                           ("dstates", dstates, (b, nc, h, p, n))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"ssd_intra_chunk_backward: {name} must be "
                             f"float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != xdt.device or not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk_backward: {name} must be "
                             f"contiguous (row-major) on {xdt.device}")
    plan = bwd_plan(b * nc, q, h, p, n, B.dtype == torch.bfloat16)
    if plan.blocks > 2 ** 31 - 1 or plan.dbc_blocks > 2 ** 31 - 1:
        raise ValueError(f"ssd_intra_chunk_backward: too many blocks "
                         f"({plan.blocks}, {plan.dbc_blocks}) for one launch")


def ssd_intra_chunk_backward(xdt, dacs, B, C, dy, dstates):
    """The gradient of the intra-chunk pass (see
    ``ssd_intra_chunk_backward_plain``): the backward kernel
    (``csrc/ssd_scan_bwd.cu``) for CUDA tensors, counted in
    ``ssd_intra_chunk_backward.launches`` (one per call, though the
    kernel runs as four passes, six for a chunk above one tile), and the
    plain version for tensors on the CPU."""
    build.dispatch()
    if xdt.device.type == "cpu":
        return ssd_intra_chunk_backward_plain(xdt, dacs, B, C, dy, dstates)
    _check_backward(xdt, dacs, B, C, dy, dstates)
    b, nc, q, h, p = xdt.shape
    n = B.shape[3]
    dxdt = torch.empty_like(xdt)
    ddacs = torch.empty_like(dacs)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    if xdt.numel() == 0:
        return dxdt, ddacs, dB.zero_(), dC.zero_()
    bc = b * nc
    plan = bwd_plan(bc, q, h, p, n, B.dtype == torch.bfloat16)
    tiles = plan.layout.tiles
    f32 = dict(dtype=torch.float32, device=xdt.device)
    dS = torch.empty((bc, q, q), **f32)
    dS_part = torch.empty((plan.hg, bc, q, q), **f32) if plan.hg > 1 else None
    dB_part = torch.empty((plan.sg + 1, bc, q, n), **f32)
    many = tiles > 1  # the tiles' partial sums
    dx_part = torch.empty((tiles, bc, q, h, p), **f32) if many else None
    rpart, cpart = ((torch.empty((bc, h, tiles, q), **f32) if many else None)
                    for _ in range(2))
    eu = torch.empty((bc, h, q), **f32) if many else None
    lib = build.load("ssd_scan_bwd", _BWD_SIGNATURES)
    args = plan.args()
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = getattr(lib, _BWD_ENTRIES[B.dtype])(
        *(t.data_ptr() if t is not None else None
          for t in (xdt, dacs, B, C, dy, dstates, dxdt, ddacs, dB, dC, dS,
                    dS_part, dB_part, rpart, cpart, eu, dx_part)),
        (ctypes.c_int * len(args))(*args), len(args), stream)
    build.check(err, "ssd_intra_chunk_backward")
    ssd_intra_chunk_backward.launches += 1
    return dxdt, ddacs, dB, dC


ssd_intra_chunk_backward.launches = 0


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
    kernels (forward and backward) for CUDA tensors, the plain versions on
    the CPU; the inter-chunk scan and ``y_off`` are plain PyTorch, and
    autograd takes the gradient through them and ``intra_chunk_inputs``."""
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
