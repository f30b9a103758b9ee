"""Structured Optimal Brain Surgeon — the ZipLM pruning algorithm (Alg. 1).

Given the out-side matrix ``W`` (d_in, d_out) of a layer, its calibration
Hessian ``H = 2 X^T X + lambda I`` and equal-width contiguous row groups
("structures"), remove structures one at a time:

  score(S) = sum_c W[S,c]^T ((H^-1)[S,S])^-1 W[S,c]        (Eq. 2)
  delta    = -H^-1[:,S] ((H^-1)[S,S])^-1 W[S,:]            (Eq. 3)
  H^-1    <-  H^-1 - H^-1[:,S] ((H^-1)[S,S])^-1 H^-1[S,:]  (Eq. 4)

snapshotting ``W`` at the requested levels. The core works on a stack of
M modules with one signature at once (a leading module axis where the
reference vmaps): each step selects per module with batched tensor ops
(scalar structures by a division, gs > 1 by a Cholesky of the (gs, gs)
diagonal blocks and one triangular solve), gathers the chosen columns
with index tensors (no per-step host sync), and runs one fused
``obs_downdate`` launch for the whole stack, updating W and Hinv in
place on the card.

``prune_structured_compact`` (and its batched twin) also shrinks the
working problem as structures die: at the level boundaries of the static
``_compaction_schedule`` (where the live set has fallen below ``ratio``
of the working size and at least ``min_rows`` rows remain) each module's
surviving structures are gathered to a contiguous prefix of fresh
row-major W and Hinv, and Algorithm 1 goes on over the (d_work, d_work)
submatrices, its downdate restricted to the ``d_live`` rows live at the
boundary. All M modules compact in lockstep on the one schedule. A
carried compact-slot -> original-structure map (``PruneResult.perm``)
records the removal orders and scatters each level's snapshot back to
its original rows, so the result has the plain path's layout; the
per-step arithmetic is the plain path's (``_select_and_downdate``).

``prune_structured_sharded`` splits a stack over the ranks of a mesh:
the stack is padded to a multiple of the shard count with replicas of
module 0, and each rank runs its block of lanes through the same core.
Lanes never interact, so the blocks are bit for bit the lanes of the
single-process run; ``gather_lanes`` puts the blocks' host arrays
together on every rank.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import axis_size, pad_leading
from ..kernels import obs_downdate


class PruneResult(NamedTuple):
    snapshots: torch.Tensor  # ([M,] n_levels, d_in, d_out) float16
    errors: torch.Tensor     # ([M,] n_levels) cumulative squared error
    order: torch.Tensor      # ([M,] n_remove) structure removed at each step
    # compacted runs only: the final compact-slot -> original-structure
    # map ([M,] work_n); None on the plain paths, where slots are the
    # original structures throughout
    perm: Optional[torch.Tensor] = None


def build_hessian(xtx: torch.Tensor, damp_frac: float = 1e-4) -> torch.Tensor:
    """H = 2 X^T X + lambda I with relative damping (batched over any
    leading dims)."""
    d = xtx.shape[-1]
    h = 2.0 * xtx
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    damp = damp_frac * diag.mean(-1) + 1e-12
    return h + damp[..., None, None] * torch.eye(d, dtype=h.dtype,
                                                 device=h.device)


def _diag_blocks(m: torch.Tensor, gs: int) -> torch.Tensor:
    """(M, d, d) -> (M, n, gs, gs) diagonal blocks of contiguous groups."""
    M, d = m.shape[0], m.shape[-1]
    n = d // gs
    blocks = torch.diagonal(m.reshape(M, n, gs, n, gs), dim1=1, dim2=3)
    return blocks.permute(0, 3, 1, 2)


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor that is NaN (as in the reference) where a block is
    not positive definite, instead of raising mid-loop."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _select_and_downdate(W, Hinv, removed, *, gs: int,
                         d_live: Optional[int] = None):
    """One Algorithm-1 step for M modules: score the live structures,
    pick the cheapest per module, run the fused rank-gs downdate.

    W (M, d_in, d_out), Hinv (M, d_in, d_in), removed (M, n) bool, all
    on one device; W, Hinv and removed are consumed (updated in place on
    the card). Shared by the plain and the compacted cores, so their
    per-step arithmetic is the same; ``d_live`` restricts the downdate to
    the compacted live prefix (the tail rows and columns are dead).
    Returns (W_new, Hinv_new, removed, s (M,), err_s (M,)).
    """
    M, d_in, d_out = W.shape
    n = removed.shape[1]
    rows = torch.arange(M, device=W.device)
    if gs == 1:
        # scalar structures: the (1,1) block solve is a division
        diag = torch.diagonal(Hinv, dim1=-2, dim2=-1)          # (M, n)
        safe = torch.where(removed, 1.0, diag)
        # on the card one pass over W, where W * W would be written and
        # read again (three times W's bytes a step, beside the downdate's
        # read and write of W and Hinv); the CPU keeps the reference's
        # expression
        if W.is_cuda:
            sq = torch.linalg.vector_norm(W, dim=-1).square()
        else:
            sq = (W * W).sum(-1)
        scores = sq / safe
        scores = torch.where(removed, float("inf"), scores.clamp_min(0.0))
        s = scores.argmin(-1)                                   # (M,)
        HcolS = Hinv[rows, :, s].unsqueeze(-1)                  # (M, d, 1)
        WS = W[rows, s].unsqueeze(1)                            # (M, 1, d_out)
        inv_s = 1.0 / safe[rows, s]                             # (M,)
        KsWS = WS * inv_s[:, None, None]
        KsHcolT = HcolS.transpose(1, 2) * inv_s[:, None, None]  # (M, 1, d)
    else:
        blocks = _diag_blocks(Hinv, gs)                         # (M,n,gs,gs)
        eye = torch.eye(gs, dtype=W.dtype, device=W.device)
        safe = torch.where(removed[..., None, None], eye, blocks)
        Lc = _cholesky_or_nan(safe)                             # (M,n,gs,gs)
        Wb = W.reshape(M, n, gs, d_out)
        V = torch.linalg.solve_triangular(Lc, Wb, upper=False)  # L^-1 W_S
        # the score sum and the two solves run module by module: on the
        # card their batched forms round a module differently in stacks
        # of other sizes (scripts/diag_torch_lane_bits.py), and a sharded
        # database runs each rank's part of the stack
        scores = torch.stack([(v * v).sum((1, 2)) for v in V])  # (M, n)
        scores = torch.where(removed, float("inf"), scores.clamp_min(0.0))
        s = scores.argmin(-1)
        idx = s[:, None] * gs + torch.arange(gs, device=W.device)  # (M, gs)
        HcolS = torch.gather(Hinv, 2, idx[:, None, :].expand(M, d_in, gs))
        WS = torch.gather(W, 1, idx[:, :, None].expand(M, gs, d_out))
        Ls = Lc[rows, s].split(1)                               # M x (1,gs,gs)
        KsWS = torch.cat([torch.cholesky_solve(b, l)            # (M, gs, d_out)
                          for b, l in zip(WS.split(1), Ls)])
        KsHcolT = torch.cat([
            torch.cholesky_solve(b, l) for b, l in
            zip(HcolS.transpose(1, 2).contiguous().split(1), Ls)])
    err = scores[rows, s]
    removed[rows, s] = True
    # paper: explicitly re-apply the overall mask — fp downdate creep
    # otherwise repopulates previously-removed rows over many steps
    row_keep = (~removed).float()
    if gs > 1:
        row_keep = row_keep.repeat_interleave(gs, dim=1)
    W_new, Hinv_new = obs_downdate(
        W, Hinv, HcolS.contiguous(), KsWS.contiguous(), KsHcolT.contiguous(),
        row_keep, d_live=d_live)
    return W_new, Hinv_new, removed, s, err


def _slot_schedule(n_remove: int, levels: Sequence[int]) -> np.ndarray:
    """Which snapshot slot each removal count writes: ``slot[i]`` is the
    index of level ``i`` in ``levels``, or ``len(levels)`` (no snapshot)
    where ``i`` is not a level."""
    n_levels = len(levels)
    slot = np.full((n_remove + 1,), n_levels, np.int32)
    for idx, lvl in enumerate(levels):
        slot[lvl] = idx
    return slot


def _pad_structs(live: int, gs: int, pad_rows: int, cap: int) -> int:
    """Smallest structure count >= live whose row count (structs * gs) is
    a pad_rows multiple, capped at the current working size: 16 fp32 rows
    keep each compacted row 64-byte aligned for the kernel."""
    if pad_rows <= 1:
        return live
    for w in range(live, cap + 1):
        if (w * gs) % pad_rows == 0:
            return w
    return live


def _compaction_schedule(n: int, gs: int, n_remove: int,
                         levels: Sequence[int], *, ratio: float = 0.75,
                         min_rows: int = 64, pad_rows: int = 16
                         ) -> List[Tuple[int, int, int, int]]:
    """Static segment plan of a live-set-compacted Algorithm-1 run (the
    reference's plan, so both packages compact at the same steps).

    Returns ``[(start, end, work_n, live_n), ...]`` covering steps
    ``[0, n_remove)``: during a segment the working arrays hold
    ``work_n`` structure slots, of which the first ``live_n`` were live
    at segment entry; the padded tail slots are dead (the zeroed tail of
    the ``d_live`` downdate). Compaction points sit on level boundaries,
    where the live set has dropped below ``ratio`` of the working size
    and at least ``min_rows`` rows survive.
    """
    segs: List[Tuple[int, int, int, int]] = []
    start, work_n, live_n = 0, n, n
    for lv in levels:
        if lv <= start or lv >= n_remove:
            continue
        live = n - lv
        if live * gs < min_rows or live > ratio * work_n:
            continue
        new_work = _pad_structs(live, gs, pad_rows, cap=work_n)
        if new_work >= work_n:
            continue
        segs.append((start, lv, work_n, live_n))
        start, work_n, live_n = lv, new_work, live
    segs.append((start, n_remove, work_n, live_n))
    return segs


def _prune_core(W: torch.Tensor, Hinv: torch.Tensor, *, group_size: int,
                n_remove: int, levels: Sequence[int],
                segs: Optional[List[Tuple[int, int, int, int]]] = None
                ) -> PruneResult:
    """Algorithm 1 for a stack of M modules (W (M, d_in, d_out), Hinv
    (M, d_in, d_in)); one Python step per removal, no host sync inside
    the loop. Snapshots are stored in float16 as they are taken.

    ``segs``, a ``_compaction_schedule``, makes it the live-set-compacted
    core: at each segment boundary every module's surviving structures
    are gathered to a prefix of fresh W and Hinv, and the loop goes on
    over the shrunk submatrices with ``d_live`` set. The step is the
    same (``_select_and_downdate``), so are the decisions. Orders are
    recorded through the carried compact-slot -> original map, and each
    level's snapshot is written to its original rows, so the result has
    the plain layout (rows compacted away stay 0, as the mask leaves
    them), with that map as ``perm``. Without ``segs`` the whole run is
    one segment and ``perm`` is None."""
    gs = group_size
    M, d_in, d_out = W.shape
    n = d_in // gs
    dev = W.device
    n_levels = len(levels)
    slot_of = _slot_schedule(n_remove, levels)

    # the downdate updates both in place, and takes row-major tensors only
    # (linalg routines on the card may return column-major results)
    W = W.float().clone(memory_format=torch.contiguous_format)
    Hinv = Hinv.float().clone(memory_format=torch.contiguous_format)
    snaps = torch.zeros((M, n_levels, d_in, d_out), dtype=torch.float16,
                        device=dev)
    errs = torch.zeros((M, n_levels), dtype=torch.float32, device=dev)
    order = torch.zeros((M, n_remove), dtype=torch.int64, device=dev)
    if slot_of[0] < n_levels:  # dense snapshot
        snaps[:, slot_of[0]] = W
    removed = torch.zeros((M, n), dtype=torch.bool, device=dev)
    cum_err = torch.zeros((M,), dtype=torch.float32, device=dev)
    mods = torch.arange(M, device=dev)
    in_group = torch.arange(gs, device=dev)
    orig_idx = orig_rows = None  # slots are the original structures
    for seg_i, (start, end, work_n, live_n) in enumerate(
            segs or [(0, n_remove, n, n)]):
        if seg_i:
            # a stable sort keeps the live structures in their relative
            # order (argmin ties break as on the plain path) and moves
            # them to the prefix; the first work_n slots are the live set
            # and the padded dead tail. No host sync: the sort and the
            # gathers run where the tensors are
            perm = torch.argsort(removed.to(torch.uint8), dim=1,
                                 stable=True)[:, :work_n]
            orig_idx = perm if orig_idx is None else \
                torch.gather(orig_idx, 1, perm)
            removed = torch.gather(removed, 1, perm)
            rows = (perm[:, :, None] * gs + in_group).reshape(M, -1)
            d_work = rows.shape[1]
            W = torch.gather(W, 1, rows[:, :, None].expand(M, d_work, d_out))
            Hinv = torch.gather(
                Hinv, 1, rows[:, :, None].expand(M, d_work, Hinv.shape[2]))
            Hinv = torch.gather(
                Hinv, 2, rows[:, None, :].expand(M, d_work, d_work))
            orig_rows = (orig_idx[:, :, None] * gs + in_group).reshape(M, -1)
        d_live = live_n * gs if live_n < work_n else None
        for i in range(start, end):
            W, Hinv, removed, s, err = _select_and_downdate(
                W, Hinv, removed, gs=gs, d_live=d_live)
            cum_err = cum_err + err
            order[:, i] = s if orig_idx is None else orig_idx[mods, s]
            slot = int(slot_of[i + 1])
            if slot < n_levels:
                if orig_rows is None:
                    snaps[:, slot] = W
                else:
                    snaps[mods[:, None], slot, orig_rows] = \
                        W.to(torch.float16)
                errs[:, slot] = cum_err
    if segs is not None and orig_idx is None:  # compacted, never shrunk
        orig_idx = torch.arange(n, device=dev).repeat(M, 1)
    return PruneResult(snapshots=snaps, errors=errs, order=order,
                       perm=orig_idx)


def prune_structured_batched(W: torch.Tensor, Hinv: torch.Tensor, *,
                             group_size: int, n_remove: int,
                             levels: Sequence[int]) -> PruneResult:
    """Algorithm 1 over a stacked module group: W (M, d_in, d_out),
    Hinv (M, d_in, d_in). Fields of the result carry the leading M."""
    with torch.no_grad():
        return _prune_core(W, Hinv, group_size=group_size,
                           n_remove=n_remove, levels=tuple(levels))


def prune_structured(W: torch.Tensor, Hinv: torch.Tensor, *,
                     group_size: int, n_remove: int,
                     levels: Sequence[int]) -> PruneResult:
    """Algorithm 1 for one module, snapshotting W after ``levels[i]``
    removals (levels ascending; level 0 is the dense weights)."""
    res = prune_structured_batched(W[None], Hinv[None],
                                   group_size=group_size, n_remove=n_remove,
                                   levels=levels)
    return PruneResult(*(t[0] for t in res[:3]))


def prune_structured_batched_compact(W: torch.Tensor, Hinv: torch.Tensor,
                                     *, group_size: int, n_remove: int,
                                     levels: Sequence[int],
                                     ratio: float = 0.75,
                                     min_rows: int = 64,
                                     pad_rows: int = 16) -> PruneResult:
    """Live-set-compacted Algorithm 1 over a stacked module group (the
    compacted twin of ``prune_structured_batched``): the whole stack
    compacts in lockstep on the one static schedule."""
    levels = tuple(levels)
    segs = _compaction_schedule(W.shape[1] // group_size, group_size,
                                n_remove, levels, ratio=ratio,
                                min_rows=min_rows, pad_rows=pad_rows)
    with torch.no_grad():
        return _prune_core(W, Hinv, group_size=group_size, n_remove=n_remove,
                           levels=levels, segs=segs)


def prune_structured_compact(W: torch.Tensor, Hinv: torch.Tensor, *,
                             group_size: int, n_remove: int,
                             levels: Sequence[int], ratio: float = 0.75,
                             min_rows: int = 64, pad_rows: int = 16
                             ) -> PruneResult:
    """Live-set-compacted Algorithm 1 for one module: the contract of
    ``prune_structured`` (the same orders, snapshots in the same layout)
    with a per-step cost that follows the live set."""
    res = prune_structured_batched_compact(
        W[None], Hinv[None], group_size=group_size, n_remove=n_remove,
        levels=levels, ratio=ratio, min_rows=min_rows, pad_rows=pad_rows)
    return PruneResult(*(t[0] for t in res))


def shard_lanes(mesh, axes, n: int) -> slice:
    """This rank's block of an ``n``-module stack padded
    (``pad_leading``) to a multiple of the shard count over ``axes``."""
    per = -(-n // axis_size(mesh, axes))
    i = mesh.index(axes)
    return slice(i * per, (i + 1) * per)


def prune_structured_sharded(W: torch.Tensor, Hinv: torch.Tensor, *, mesh,
                             axes, group_size: int, n_remove: int,
                             levels: Sequence[int], compact: bool = False
                             ) -> PruneResult:
    """Device-parallel twin of ``prune_structured_batched[_compact]``
    over the ranks of ``mesh``'s ``axes``: the stack is padded with
    replicas of module 0 and this rank runs its block
    (:func:`shard_lanes`) through the same core. Returns the block's
    result, on this rank's device: the caller checks and fetches it, and
    :func:`gather_lanes` puts the fetched blocks together."""
    blk = shard_lanes(mesh, axes, W.shape[0])
    k = axis_size(mesh, axes)
    prune = (prune_structured_batched_compact if compact
             else prune_structured_batched)
    return prune(pad_leading(W, k)[blk], pad_leading(Hinv, k)[blk],
                 group_size=group_size, n_remove=n_remove, levels=levels)


def gather_lanes(mesh, axes, n: int, *blocks: np.ndarray
                 ) -> Tuple[np.ndarray, ...]:
    """Every rank's host block of each array (from
    :func:`prune_structured_sharded`), concatenated in shard order and
    sliced back to the ``n`` modules: the same bits on every rank."""
    return tuple(mesh.all_gather(b, axes)[:n] for b in blocks)


def module_drop_error(W: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """||W X||^2 = tr(W^T H_raw W) with H_raw = X^T X (module-drop error,
    and the denominator of the SPDY prior p_s)."""
    Wf = W.float()
    return torch.einsum("ic,ij,jc->", Wf, H.float(), Wf)


def module_drop_errors(W: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Batched module_drop_error: (L, d_in, d_out) x (L, d_in, d_in) -> (L,)."""
    Wf = W.float()
    return torch.einsum("lic,lij,ljc->l", Wf, H.float(), Wf)
