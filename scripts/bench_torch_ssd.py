#!/usr/bin/env python3
"""Time the port's ssd_intra_chunk kernel at the shapes of its paths,
beside its plain version and the card's bound.

    python3 scripts/bench_torch_ssd.py [--tree DIR] [--label NAME] [--ablate]
    python3 scripts/bench_torch_ssd.py --backward [--tree DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout), so
that two versions of the kernel can be timed in turns on one card: run
it once per tree, in the order parent, change, change, parent. The
shapes, the check and the timing are ``chip_smoke.py``'s ``time_ssd`` at
``SSD_TIMED`` (Mamba-2 2.7B's calibration batch, (b, nc, Q, P, N) = (8,
4, 128, 64, 128) with bf16 B and C, at 80, 40 and 16 heads): eager times
(CUDA events around 20 calls) and device times (CUDA graph replay) of
the kernel, the plain version's eager time and the bound, printed per
shape, then one JSON line of the rows.

``--ablate`` (this checkout's kernel only) also builds copies of
``csrc/ssd_scan.cu`` with one part of the work switched off or swapped
(``ABLATIONS``: the y_diag or states products, the score pass, the
global stores, the xdt copies, TF32 rounding by ``cvt.rna``), launches
each with the wrapper's plan and prints its device time (graph replay)
at each timed shape: where the time goes inside the kernel. The switched
copies compute wrong results and are used for nothing else.

``--backward`` times the backward kernel instead (``csrc/ssd_scan_bwd.cu``,
``ssd_intra_chunk_backward``): ``chip_smoke.py``'s ``time_ssd_backward``
at ``SSD_MAIN``, the Mamba-2 2.7B train step's shape (b, nc, Q, H, P, N)
= (8, 4, 128, 80, 64, 128) with bf16 B and C, checked against its plain
version first: its eager time (``ms``), its device time by CUDA graph
replay (``device_ms``), each pass's device time (``passes_ms``, from
``torch.profiler``), the plain version's eager time and the bound. It
works on any tree whose ``repro_torch`` has that function, so a parent's
and a change's backward are timed in turns the same way. With
``--ablate`` it also builds copies of ``csrc/ssd_scan_bwd.cu`` with one
part switched off (``BWD_ABLATIONS``: dx_pass's W, G, R and dS, (S o
L)^T dy products, its score pass or its operand copies; dbc_pass's
products or copies) and times each through the wrapper by graph replay
and by pass.

Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the helpers, not the smoke run)

# name -> [(text in csrc/ssd_scan.cu, its replacement)]; "pl.n < 0" and
# "pl.n > 0" are conditions the compiler cannot decide (n > 0 always)
_NO_Y = [("  for (int j0 = j_begin; j0 < j_end; j0 += 8) {",
          "  for (int j0 = j_begin; j0 < j_end && sp.c0 < 0; j0 += 8) {")]
_NO_STATES = [("r0 < QT; r0 += 8) {", "r0 < QT && pl.n < 0; r0 += 8) {")]
_NO_SCORES = [("kb * KB < kend; ++kb)", "kb * KB < kend && pl.n < 0; ++kb)")]
_NO_STORES = [("if (row >= q) continue;", "if (row >= q || pl.n > 0) continue;"),
              ("float* out = sb + (size_t)(16 * rb + g + 8 * half) * n + col;",
               "if (pl.n > 0) continue;\n"
               "float* out = sb + (size_t)(16 * rb + g + 8 * half) * n + col;")]
_NO_LOADS = [("    stage<float>(xs + (k & 1) * QT * LDX,",
              "    if (pl.n < 0) stage<float>(xs + (k & 1) * QT * LDX,")]
ABLATIONS = {
    "kernel": [],
    "no y_diag products": _NO_Y,
    "no states products": _NO_STATES,
    "no products": _NO_Y + _NO_STATES,
    "no score pass": _NO_SCORES,
    "no global stores": _NO_STORES,
    "no xdt copies": _NO_LOADS,
    "compute only (no stores, no xdt copies)": _NO_STORES + _NO_LOADS,
    "copies only (no products, no score pass)": _NO_Y + _NO_STATES
    + _NO_SCORES,
    "TF32 rounding by cvt.rna": [
        ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "  unsigned r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) "
         ": \"f\"(x));\n  return r;")],
}


# the same for csrc/ssd_scan_bwd.cu (--backward --ablate): dx_pass's parts,
# then dbc_pass's
_NO_W = [("for (int n0 = 0; n0 < slab_w(sl); n0 += 8) {",
          "for (int n0 = 0; n0 < slab_w(sl) && pl.n < 0; n0 += 8) {")]
_NO_G = [("for (int p0 = 0; p0 < P; p0 += 8) {",
          "for (int p0 = 0; p0 < P && pl.n < 0; p0 += 8) {")]
_NO_RDS = [("          if (c >= KC) continue;\n          const float4 sv",
            "          if (c >= KC || pl.n > 0) continue;\n          const float4 sv")]
_NO_DX = [("for (int c = ca; c < KC; ++c) {",
           "for (int c = ca; c < KC && pl.n < 0; ++c) {")]
_NO_S = [("for (int kk = 0; kk < w; kk += KSTEP) {",
          "for (int kk = 0; kk < w && pl.n < 0; kk += KSTEP) {")]
_NO_RING = [("    if (op >= nops) return;", "    if (op >= nops || pl.n > 0) return;")]
_NO_DBC_MMA = [("for (int kk = 0; kk < DK; kk += 8) {",
                "for (int kk = 0; kk < DK && pl.n < 0; kk += 8) {")]
_NO_DBC_COPIES = [("    if (i >= nk) return;", "    if (i >= nk || pl.n > 0) return;")]
BWD_ABLATIONS = {
    "kernel": [],
    "dx_pass: no W products": _NO_W,
    "dx_pass: no G products": _NO_G,
    "dx_pass: no R and dS (decays, sums)": _NO_RDS,
    "dx_pass: no (S o L)^T dy products": _NO_DX,
    "dx_pass: no products": _NO_W + _NO_G + _NO_DX,
    "dx_pass: no score pass": _NO_S,
    "dx_pass: no operand copies": _NO_RING,
    "dbc_pass: no products": _NO_DBC_MMA,
    "dbc_pass: no copies": _NO_DBC_COPIES,
}


def build_ablations(ssd_scan, build, source="ssd_scan", ablations=None,
                    signatures=None):
    """{name: loaded library} of ``ablations`` (ABLATIONS of
    csrc/ssd_scan.cu by default), compiled in parallel into
    build/ssd_ablations/."""
    ablations = ABLATIONS if ablations is None else ablations
    signatures = ssd_scan._SIGNATURES if signatures is None else signatures
    src = (build.CSRC / f"{source}.cu").read_text()
    out = build.BUILD_DIR.parent / "ssd_ablations"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(ablations.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: {old!r} is not in "
                                   f"csrc/{source}.cu")
            text = text.replace(old, new)
        cu, so = out / f"{source}_v{i}.cu", out / f"lib{source}_v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in signatures.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablate(torch, g):
    from repro_torch.kernels import build, ssd_scan
    libs = build_ablations(ssd_scan, build)
    rows = []
    for case in cs.SSD_TIMED:
        x, dt, A, B, C = cs.ssd_data(torch, case, torch.bfloat16, g)
        xdt, dacs, Bb, Cb = ssd_scan.intra_chunk_inputs(x, dt, A, B, C,
                                                        case[-1])
        b, nc, q, h, p = xdt.shape
        n = Bb.shape[-1]
        plan = ssd_scan.launch_plan(xdt, Bb)
        lay = plan.layout
        y = torch.empty_like(xdt)
        st = torch.empty((b, nc, h, p, n), device="cuda")
        ws = None if lay.tiles == 1 else torch.empty(
            (lay.tiles, b, nc, h, p, n), device="cuda")
        row = {"shape": [b, nc, q, h, p, n]}
        for name, lib in libs.items():
            def call(lib=lib):
                err = getattr(lib, ssd_scan._ENTRIES[Bb.dtype])(
                    xdt.data_ptr(), dacs.data_ptr(), Bb.data_ptr(),
                    Cb.data_ptr(), y.data_ptr(), st.data_ptr(),
                    ws.data_ptr() if ws is not None else None, b * nc, q, h,
                    p, n, lay.qt, lay.tiles, plan.groups, lay.smem,
                    lay.off_s, lay.off_b, lay.off_dac, lay.off_dec,
                    torch.cuda.current_stream().cuda_stream)
                build.check(err, f"ablation {name!r}")
            row[name] = cs.graph_ms(call)
            print(f"ssd_intra_chunk ablation {tuple(row['shape'])}: {name}: "
                  f"{row[name]:.4f} ms device (graph)")
        rows.append(row)
    return rows


def ablate_backward(torch, g):
    """Each of BWD_ABLATIONS through the wrapper (its library swapped in)
    at SSD_MAIN with bf16 B and C: device ms a call by graph replay and
    by pass (profiler)."""
    from repro_torch.kernels import build, ssd_scan
    libs = build_ablations(ssd_scan, build, "ssd_scan_bwd", BWD_ABLATIONS,
                           ssd_scan._BWD_SIGNATURES)
    args = cs.ssd_backward_inputs(torch, cs.SSD_MAIN, "bfloat16", "bfloat16",
                                  g)
    real = build._LIBS.get("ssd_scan_bwd")
    rows = {}
    try:
        for name, lib in libs.items():
            build._LIBS["ssd_scan_bwd"] = lib
            call = lambda: ssd_scan.ssd_intra_chunk_backward(*args)  # noqa
            rows[name] = {"device_ms": cs.graph_ms(call),
                          "passes_ms": cs.passes_ms(torch, call)}
            print(f"ssd_intra_chunk_backward ablation: {name}: "
                  f"{rows[name]['device_ms']:.4f} ms device (graph); "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in rows[name]["passes_ms"].items()))
    finally:
        if real is None:
            build._LIBS.pop("ssd_scan_bwd", None)
        else:
            build._LIBS["ssd_scan_bwd"] = real
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the kernel with parts off")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernel at the train step's "
                         "shape instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_ssd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.ablate and os.path.abspath(args.tree) != ROOT:
        print("bench_torch_ssd: --ablate edits this checkout's kernel only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels.ssd_scan import (ssd_intra_chunk,
                                              ssd_intra_chunk_plain)
    card, label = cs.card_line(), args.label or args.tree
    print(f"{card}; kernel from {args.tree}")
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.backward:
        from repro_torch.kernels.ssd_scan import (
            ssd_intra_chunk_backward, ssd_intra_chunk_backward_plain)
        rec = cs.time_ssd_backward(torch, ssd_intra_chunk_backward,
                                   ssd_intra_chunk_backward_plain, g)
        result = {"label": label, "card": card, "backward": rec}
        if args.ablate:
            result["ablations"] = ablate_backward(torch, g)
        print(json.dumps(result))
        return 0
    rows = cs.time_ssd(torch, ssd_intra_chunk, ssd_intra_chunk_plain, g,
                       cs.SSD_TIMED)
    result = {"label": label, "card": card, "shapes": rows}
    if args.ablate:
        result["ablations"] = ablate(torch, g)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
