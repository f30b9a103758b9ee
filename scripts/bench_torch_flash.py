#!/usr/bin/env python3
"""Time the port's flash-attention kernel at GPT-2 small's serving
prefills, beside ``scaled_dot_product_attention`` and the card's bound.

    python3 scripts/bench_torch_flash.py [--tree DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout), so
that two versions of the kernel can be timed in turns on one card: run
it once per tree, in the order parent, change, change, parent. The
shapes, the check and the timing are ``chip_smoke.py``'s ``time_flash``
at ``FLASH_TIMED`` (bf16, causal, 12 heads of 64, batch 1 at 128, 256,
512 and 1024 tokens and 8 prompts of 1024): eager and device-only
(CUDA graph) times of kernel and SDPA, the plain version's eager time
and the bound, printed per shape, then one JSON line of the rows.

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
        print("bench_torch_flash: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    card, label = cs.card_line(), args.label or args.tree
    print(f"{card}; kernel from {args.tree}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = cs.time_flash(torch, flash_attention, flash_attention_plain, g,
                         cs.FLASH_TIMED)
    print(json.dumps({"label": label, "card": card, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
