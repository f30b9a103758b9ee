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
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..kernels import obs_downdate


class PruneResult(NamedTuple):
    snapshots: torch.Tensor  # ([M,] n_levels, d_in, d_out) float16
    errors: torch.Tensor     # ([M,] n_levels) cumulative squared error
    order: torch.Tensor      # ([M,] n_remove) structure removed at each step


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


def _select_and_downdate(W, Hinv, removed, *, gs: int):
    """One Algorithm-1 step for M modules: score the live structures,
    pick the cheapest per module, run the fused rank-gs downdate.

    W (M, d_in, d_out), Hinv (M, d_in, d_in), removed (M, n) bool, all
    on one device; W, Hinv and removed are consumed (updated in place on
    the card). Returns (W_new, Hinv_new, removed, s (M,), err_s (M,)).
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
        scores = (V * V).sum((2, 3))
        scores = torch.where(removed, float("inf"), scores.clamp_min(0.0))
        s = scores.argmin(-1)
        idx = s[:, None] * gs + torch.arange(gs, device=W.device)  # (M, gs)
        HcolS = torch.gather(Hinv, 2, idx[:, None, :].expand(M, d_in, gs))
        WS = torch.gather(W, 1, idx[:, :, None].expand(M, gs, d_out))
        Ls = Lc[rows, s]                                        # (M, gs, gs)
        KsWS = torch.cholesky_solve(WS, Ls)                     # (M, gs, d_out)
        KsHcolT = torch.cholesky_solve(HcolS.transpose(1, 2).contiguous(), Ls)
    err = scores[rows, s]
    removed[rows, s] = True
    # paper: explicitly re-apply the overall mask — fp downdate creep
    # otherwise repopulates previously-removed rows over many steps
    row_keep = (~removed).float()
    if gs > 1:
        row_keep = row_keep.repeat_interleave(gs, dim=1)
    W_new, Hinv_new = obs_downdate(
        W, Hinv, HcolS.contiguous(), KsWS.contiguous(), KsHcolT.contiguous(),
        row_keep)
    return W_new, Hinv_new, removed, s, err


def _prune_core(W: torch.Tensor, Hinv: torch.Tensor, *, group_size: int,
                n_remove: int, levels: Sequence[int]) -> PruneResult:
    """Algorithm 1 for a stack of M modules (W (M, d_in, d_out), Hinv
    (M, d_in, d_in)); one Python step per removal, no host sync inside
    the loop. Snapshots are stored in float16 as they are taken."""
    gs = group_size
    M, d_in, d_out = W.shape
    n = d_in // gs
    dev = W.device
    slot_of = {lvl: i for i, lvl in enumerate(levels)}

    # the downdate updates both in place, and takes row-major tensors only
    # (linalg routines on the card may return column-major results)
    W = W.float().clone(memory_format=torch.contiguous_format)
    Hinv = Hinv.float().clone(memory_format=torch.contiguous_format)
    snaps = torch.zeros((M, len(levels), d_in, d_out), dtype=torch.float16,
                        device=dev)
    errs = torch.zeros((M, len(levels)), dtype=torch.float32, device=dev)
    order = torch.zeros((M, n_remove), dtype=torch.int64, device=dev)
    if 0 in slot_of:  # dense snapshot
        snaps[:, slot_of[0]] = W
    removed = torch.zeros((M, n), dtype=torch.bool, device=dev)
    cum_err = torch.zeros((M,), dtype=torch.float32, device=dev)
    for i in range(n_remove):
        W, Hinv, removed, s, err = _select_and_downdate(W, Hinv, removed,
                                                        gs=gs)
        cum_err = cum_err + err
        order[:, i] = s
        slot = slot_of.get(i + 1)
        if slot is not None:
            snaps[:, slot] = W
            errs[:, slot] = cum_err
    return PruneResult(snapshots=snaps, errors=errs, order=order)


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
    return PruneResult(*(t[0] for t in res))


def module_drop_error(W: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """||W X||^2 = tr(W^T H_raw W) with H_raw = X^T X (module-drop error,
    and the denominator of the SPDY prior p_s)."""
    Wf = W.float()
    return torch.einsum("ic,ij,jc->", Wf, H.float(), Wf)


def module_drop_errors(W: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Batched module_drop_error: (L, d_in, d_out) x (L, d_in, d_in) -> (L,)."""
    Wf = W.float()
    return torch.einsum("lic,lij,ljc->l", Wf, H.float(), Wf)
