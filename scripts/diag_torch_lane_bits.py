#!/usr/bin/env python3
"""Which calls of the database's Algorithm-1 step give a module's lane
other bits on the card when the stack holds another number of lanes.

    python3 scripts/diag_torch_lane_bits.py

For each (M, d_in, d_out, gs) in ``CASES`` it draws W and a damped
Hessian on the card (seed 0), and runs each call of the Algorithm-1 step
in its batched form over the whole stack of M lanes, over its first M/2
lanes and over its first lane alone; it prints whether the first lanes'
results are bit-equal (``half``, ``one``). Then the same for the whole
prune (``obs.prune_structured_batched``, 40 removals). A sharded
database runs each rank's block of lanes, so a call that prints False
would change the bits of a sharded build against the single-process one
at that lane count; the step runs those calls module by module, and the
whole prune must print True everywhere. Needs an NVIDIA GPU.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.core import obs  # noqa: E402
from repro_torch.core.database import _inverse_or_nan  # noqa: E402
from repro_torch.core.obs import (_cholesky_or_nan, _diag_blocks,  # noqa: E402
                                  build_hessian)

# the card test's small GPT-2 (attention, FFN), GPT-2 small at 6 layers
# (attention, FFN), and the small attention at 4 lanes
CASES = [(2, 128, 128, 32), (2, 512, 128, 1), (6, 768, 768, 64),
         (6, 3072, 768, 1), (4, 128, 128, 32)]


def calls(gs, d_out):
    """name -> fn(W, Hinv) for each call of the step at group size gs."""
    out = {
        "vector_norm": lambda W, Hi: torch.linalg.vector_norm(
            W, dim=-1).square(),
        "inverse": lambda W, Hi: _inverse_or_nan(build_hessian(Hi)),
    }
    if gs == 1:
        return out

    def chol(W, Hi):
        return _cholesky_or_nan(_diag_blocks(Hi, gs))

    def solve(W, Hi):
        n = W.shape[1] // gs
        return torch.linalg.solve_triangular(
            chol(W, Hi), W.reshape(W.shape[0], n, gs, d_out), upper=False)

    out.update({
        "cholesky": chol,
        "solve_triangular": solve,
        "score_sum": lambda W, Hi: (solve(W, Hi) ** 2).sum((2, 3)),
        "cholesky_solve": lambda W, Hi: torch.cholesky_solve(
            W[:, :gs].contiguous(), chol(W, Hi)[:, 0]),
    })
    return out


def prune(gs, d_in):
    n_remove = min(d_in // gs, 40)

    def run(W, Hi):
        r = obs.prune_structured_batched(
            W, Hi, group_size=gs, n_remove=n_remove,
            levels=tuple(range(0, n_remove + 1, 4)))
        return torch.cat([r.errors.double().flatten(1), r.order.double(),
                          r.snapshots.double().flatten(1)], 1)
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for M, d_in, d_out, gs in CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        W = torch.randn(M, d_in, d_out, device="cuda", generator=g)
        X = torch.randn(M, 3 * d_in, d_in, device="cuda", generator=g)
        Hinv = _inverse_or_nan(build_hessian(X.mT @ X / X.shape[1]))
        fns = dict(calls(gs, d_out), whole_prune=prune(gs, d_in))
        row = []
        for name, fn in fns.items():
            full = fn(W, Hinv)
            same = [bool(torch.equal(full[:k], fn(W[:k].contiguous(),
                                                  Hinv[:k].contiguous())))
                    for k in (M // 2, 1)]
            row.append(f"{name}: half {same[0]} one {same[1]}")
        print(f"(M, d_in, d_out, gs) = {(M, d_in, d_out, gs)}: "
              + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
