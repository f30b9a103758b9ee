#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's one-shot path, on one GPU.

    python3 scripts/profile_torch_oneshot.py [--arch gpt2-small]
        [--layers N] [--steps 48] [--moe-prune-unit width|expert]

Runs ``oneshot_prune`` on an architecture of the port's config registry
(``repro_torch.configs.ARCHS``) at full width: GPT-2 small (12 layers,
targets 1.5x/2x/3x), Mamba-2 2.7B (``--arch mamba2-2.7b``: 8 of its 64
layers, as ``chip_smoke.py`` phase 6 runs it), Phi-3.5-MoE (``--arch
phi3.5-moe-42b-a6.6b``: 1 of its 32 layers, as phase 7 runs it, in the
MoE prune mode ``--moe-prune-unit`` names) or any other at 1 layer, the
others with targets 1.25x/1.5x/2x; seeded weights, 32 x 512 calibration
tokens and a latency table measured for batch 16 x 128 prefill, once to
warm up and once under
``torch.profiler``. ``oneshot_prune`` marks each of its stages as a
profiler range ``oneshot_prune.<stage>``; every device activity (kernel
or copy) is put in the stage whose range it starts in. For each stage it
prints the host seconds (``OneShotResult.stage_seconds``, ending in a
synchronize), the device-busy seconds (the sum of the activities' device
time: one stream, so they do not overlap), the idle share, and the
activities that take the most device time. The stages' activities come
from the profiler's raw events: building its ``FunctionEvent`` tree
(``prof.events()``) from the Mamba-2 run's 290,000 host events ran for
more than 400 s without ending. Last it prints the count of events and its own wall
time, and the process exits.

Needs a GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import sys
import time
from collections import defaultdict

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

RANGE = "oneshot_prune."
# the default depth of an arch (1 layer where none is named: a full-width
# layer of the larger configs is already several GB of weights and
# database), and its targets
DEPTH = {"gpt2-small": 12, "mamba2-2.7b": 8}
TARGETS = {"gpt2-small": [1.5, 2.0, 3.0]}


def stage_activity(prof):
    """({stage: {activity name: [device us, count]}}, host events, device
    events) from a profile. Reads the profiler's raw events and never
    builds its ``FunctionEvent`` tree (``prof.events()``), whose cost
    grows with every host op recorded."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host, device, ranges = 0, [], []
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            device.append(e)
        elif kind == DeviceType.CPU:
            host += 1
            if e.name().startswith(RANGE):
                ranges.append((e.start_ns(), e.end_ns(), e.name()[len(RANGE):]))
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for e in device:
        name, start = e.name(), e.start_ns()
        i = bisect.bisect_right(starts, start) - 1
        if name.startswith(RANGE) or i < 0 or start > ranges[i][1]:
            continue  # a range's device projection, or outside every stage
        rec = out[ranges[i][2]][name]
        rec[0] += e.duration_ns() / 1e3
        rec[1] += 1
    return out, host, len(device)


def main() -> int:
    sys.path.insert(0, SRC)
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(configs.ARCHS),
                    default="gpt2-small")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: 12 for gpt2-small, 8 for "
                         "mamba2-2.7b, 1 for the others)")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--moe-prune-unit", choices=("width", "expert"),
                    default="width")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.data import calibration_batches
    from repro_torch.models import model_init
    from repro_torch.runtime.costmodel import InferenceEnv

    targets = TARGETS.get(args.arch, [1.25, 1.5, 2.0])
    cfg = configs.get_config(args.arch).replace(
        num_layers=args.layers or DEPTH.get(args.arch, 1),
        moe_prune_unit=args.moe_prune_unit)
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    calib = calibration_batches(cfg, 32, 512, batch=8)
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    print(f"{cfg.name}: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"d_ff={cfg.d_ff} ssm_heads={cfg.ssm_heads} experts="
          f"{cfg.num_experts} ({cfg.moe_prune_unit} mode) dtype={cfg.dtype}, "
          f"targets {targets}")

    def run():
        return oneshot_prune(cfg, params, calib, env, targets,
                             latency_backend="measure",
                             latency_kw={"reps": 50, "warmup": 5},
                             search_steps=args.steps, search_pop=16, seed=0,
                             device="cuda")

    run()  # warm-up: cuBLAS/cuSOLVER handles, kernel builds, allocator
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run()
    t0 = time.perf_counter()
    acts, n_host, n_device = stage_activity(prof)
    print(f"profiler: {n_host} host and {n_device} device events, read in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, host_s in res.stage_seconds.items():
        per = acts.get(name, {})
        busy_s = sum(us for us, _ in per.values()) / 1e6
        print(f"\n[{name}] host {host_s:.4f} s, device busy {busy_s:.4f} s, "
              f"idle share {max(0.0, 1 - busy_s / host_s):.3f}")
        for act, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0]
                                   )[:args.top]:
            print(f"  {us / 1e3:10.3f} ms  {n:7d}x  {act[:90]}")
    for t, v in res.variants.items():
        print(f"  {t}x: speedup {v.speedup:.3f}x, evals {v.search.n_evals}")
    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
