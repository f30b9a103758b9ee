#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves GPT-2 small, on one GPU.

    python3 scripts/profile_torch_serve.py [--layers 12] [--requests 16]

Serves one seeded stream (8 slots, ``max_len`` 1024, prompts of 128-768
tokens, 16-64 generated tokens, 50 req/s; chip_smoke.py's phase-5
stream) through the dense GPT-2 small (bf16, seeded weights, prefill
through the flash-attention kernel) and through a 2x member shrunk from
the magnitude baseline (``uniform_assignment`` over a table measured on
the card). Each engine runs the stream once to warm up and once under
``torch.profiler``. The engine marks each timed step as a profiler range
``serve.prefill`` or ``serve.decode``; every device activity is put in
the range it starts in. For each kind of step it prints the host seconds
(the ranges' durations, each ending in the pull of its logits), the
device-busy seconds (one stream, so activities do not overlap), the idle
share, the launches per step, and the activities with the most device
time.

Needs a GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import sys
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

RANGES = ("serve.prefill", "serve.decode")
STREAM = {"seed": 0, "rate": 50.0, "prompt_lens": (128, 256, 512, 768),
          "steps_range": (16, 64)}


def range_activity(prof):
    """{range: (host us, count, {activity: [device us, count]})}."""
    from torch.autograd import DeviceType
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name in RANGES)
    starts = [r[0] for r in ranges]
    host = defaultdict(lambda: [0.0, 0])
    for lo, hi, name in ranges:
        host[name][0] += hi - lo
        host[name][1] += 1
    acts = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in RANGES:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.time_range.start > ranges[i][1]:
            continue  # between steps
        rec = acts[ranges[i][2]][e.name]
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    return {name: (host[name][0], host[name][1], acts[name])
            for name in RANGES if name in host}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()

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

    from repro_torch.configs import GPT2_SMALL
    from repro_torch.core.latency import build_table
    from repro_torch.core.magnitude import baseline_database, \
        uniform_assignment
    from repro_torch.models import model_init
    from repro_torch.runtime.costmodel import InferenceEnv
    from repro_torch.serve import FamilyServer, synthetic_requests

    cfg = GPT2_SMALL.replace(num_layers=args.layers, attn_impl="flash_lax")
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    db = baseline_database(cfg, params)
    table = build_table(cfg, InferenceEnv(batch=16, seq=128, mode="prefill",
                                          hw=None),
                        backend="measure", device="cuda", reps=20, warmup=3)
    server = FamilyServer(cfg, params, db,
                          {2.0: uniform_assignment(cfg, table, 2.0)},
                          max_len=1024, num_slots=8)
    reqs = synthetic_requests(cfg, args.requests, **STREAM)
    print(f"{cfg.name}: layers={cfg.num_layers} attn_impl={cfg.attn_impl} "
          f"dtype={cfg.dtype}; {len(reqs)} requests, 8 slots, max_len 1024")
    for target, eng in sorted(server.members.items()):
        eng.run(reqs)  # warm-up: every bucket, cuBLAS handles, allocator
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rep = eng.run(reqs)
        m = rep.as_dict()
        print(f"\n== member {target}x: {m['total_tokens']} tokens, prefill "
              f"{m['prefill_ms_mean']:.4f} ms, decode "
              f"{m['decode_ms_per_token_mean']:.4f} ms/token, "
              f"{m['tokens_per_s']:.2f} tokens/s (under the profiler)")
        for name, (host_us, n, per) in range_activity(prof).items():
            busy_us = sum(us for us, _ in per.values())
            launches = sum(c for _, c in per.values())
            print(f"[{name}] {n} steps: host {host_us / 1e6:.4f} s "
                  f"({host_us / n / 1e3:.4f} ms/step), device busy "
                  f"{busy_us / 1e6:.4f} s, idle share "
                  f"{max(0.0, 1 - busy_us / host_us):.3f}, "
                  f"{launches / n:.1f} device activities/step")
            for act, (us, c) in sorted(per.items(), key=lambda kv: -kv[1][0]
                                       )[:args.top]:
                print(f"  {us / 1e3:10.3f} ms  {c:7d}x  {act[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
