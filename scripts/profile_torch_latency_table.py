#!/usr/bin/env python3
"""What the measured latency table times, module by module, on one GPU.

    python3 scripts/profile_torch_latency_table.py [--arch hymba-1.5b]
        [--arch gpt2-small ...] [--levels 0,1,-1]

For each architecture of the port's config registry and each unit kind
it prunes (``core.latency._kinds_for``), takes the kind's timing module
at a few levels of its grid (``--levels``: indices into the grid, the
last dropped level skipped as it times nothing), in the environment of
``chip_smoke.py``'s one-shot phases (16 x 128 prefill, the config's
compute type), and prints for each:

* ``table_ms``: the table's own number (``core.latency._time_fn``: 5
  untimed calls, 50 calls captured in one CUDA graph, and CUDA events
  around a replay of it, as phase 4 builds it);
* ``device_ms``: the device time a call, from ``torch.profiler`` over 10
  calls (the sum of its kernels' and copies' device time), and the host
  wall time a call over the same calls;
* the activities that take the most device time a call.

A module whose ``table_ms`` is far above its ``device_ms`` is timed by
its host path, not by the device (the fault of the eager timing that the
graph replay replaced); ``table_ms`` near ``device_ms`` is device time. Needs a GPU; prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
PROFILED = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def profile_call(torch, fn, args):
    """(device ms a call, host ms a call, [(activity, device ms a call)])
    over PROFILED calls after 3 untimed ones."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            fn(*args)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / PROFILED * 1e3
    acts = {}
    for e in prof.key_averages():
        # the device's own activities (kernels, copies): an operator's row
        # (device type CPU) repeats its kernels' time as its own
        us = getattr(e, "self_device_time_total", 0)
        if us and str(e.device_type).endswith("CUDA"):
            acts[e.key] = acts.get(e.key, 0.0) + us / 1e3 / PROFILED
    top = sorted(acts.items(), key=lambda kv: -kv[1])
    return sum(acts.values()), host, top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append")
    ap.add_argument("--levels", default="0,1,-2")
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import latency
    from repro_torch.core.structures import UNITS
    from repro_torch.models.layers import compute_dtype
    from repro_torch.runtime.costmodel import InferenceEnv

    print(card_line())
    dev = torch.device("cuda")
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    picks = [int(i) for i in args.levels.split(",")]
    rows = []
    for arch in args.arch or ["hymba-1.5b", "gpt2-small"]:
        cfg = get_config(arch)
        dt = compute_dtype(cfg)
        gen = torch.Generator().manual_seed(0)
        for kind in latency._kinds_for(cfg):
            grid = latency._grid_for(cfg, kind)
            for i in sorted({p % len(grid) for p in picks}):
                removed = int(grid[i])
                spec = UNITS[kind].timing_spec(cfg, env, removed)
                if spec is None:
                    continue
                if spec["module"] == "attn":
                    fn, fargs = latency._attn_timing_module(
                        cfg, env, spec["groups"], gen, dt, dev)
                else:
                    fn, fargs = latency._ffn_timing_module(
                        cfg, spec["tokens"], spec["f_live"], gen, dt, dev)
                with torch.no_grad():
                    table = latency._time_fn(fn, *fargs, reps=50, warmup=5,
                                             dev=dev) * 1e3
                    device, host, top = profile_call(torch, fn, fargs)
                row = {"arch": arch, "kind": kind, "removed": removed,
                       "spec": spec, "table_ms": table, "device_ms": device,
                       "host_ms": host,
                       "top": [(k[:90], round(v, 4)) for k, v in top[:6]]}
                rows.append(row)
                print(f"{arch} {kind} removed {removed} {spec}: table "
                      f"{table:.4f} ms, device {device:.4f} ms a call, host "
                      f"{host:.4f} ms a call; top: " + "; ".join(
                          f"{k} {v:.4f}" for k, v in row["top"]))
    print(json.dumps({"card": card_line(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
