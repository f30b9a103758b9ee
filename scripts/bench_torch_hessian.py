#!/usr/bin/env python3
"""Time the port's hessian_accum kernel at the widths of its paths, beside
``torch.addmm`` and the card's bound.

    python3 scripts/bench_torch_hessian.py [--tree DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout), so
that two versions of the kernel can be timed in turns on one card: run
it once per tree, in the order parent, change, change, parent. The
shapes, the check and the timing are ``chip_smoke.py``'s ``time_hessian``
at ``HESSIAN_TIMED`` (N = 4096 calibration rows, D = 3072, 768 and 5120,
fp32 with an accumulator): eager times (CUDA events around 20 calls) of
the kernel, its plain version and ``torch.addmm(acc, x.T, x)``, and the
bound, printed per shape, then one JSON line of the rows.

Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the helpers, not the smoke run)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_hessian: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # addmm in full fp32
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels.hessian_accum import (hessian_accum,
                                                   hessian_accum_plain)
    card, label = cs.card_line(), args.label or args.tree
    print(f"{card}; kernel from {args.tree}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = cs.time_hessian(torch, hessian_accum, hessian_accum_plain, g,
                           cs.HESSIAN_TIMED)
    print(json.dumps({"label": label, "card": card, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
