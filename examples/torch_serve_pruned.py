"""Serve a dense vs ZipLM-pruned model with batched requests on the PyTorch
port: prefill + greedy decode, measuring wall-clock per generated token on
the GPU (``--device cpu`` runs the plain PyTorch path; the paper's 'pruning
for latency' story, §4.2). Priced by the cost model on the H100 SXM data
sheet (``runtime.costmodel.H100_SXM``).

  PYTHONPATH=src python examples/torch_serve_pruned.py [--device cpu]
"""
import argparse
import os
import sys
import time

# the train step runs under torch.use_deterministic_algorithms, which on
# CUDA needs a fixed cuBLAS workspace, set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import GPT2_SMALL
from repro_torch.configs.base import TrainConfig
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.data import calibration_batches, synthetic_stream
from repro_torch.models import (generate, model_init, serve_prefill,
                                serve_step)
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
from repro_torch.runtime.device import resolve_device, synchronize
from repro_torch.train import make_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = GPT2_SMALL.replace(name="gpt2-tiny", num_layers=4, d_model=96,
                             d_ff=384, num_heads=6, num_kv_heads=6,
                             head_dim=16, vocab_size=384, dtype="float32")
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=120)
    step = make_train_step(cfg, tcfg, device=dev)
    state = make_train_state(cfg, params, tcfg)
    data = synthetic_stream(cfg, 16, 64, seed=7)
    for _ in range(120):
        state, _ = step(state, next(data))
    params = state.params

    # prune for the *latency* environment (batch=1 decode)
    env = InferenceEnv(batch=1, seq=64, mode="decode", hw=H100_SXM)
    calib = calibration_batches(cfg, 16, 64, batch=8)
    res = oneshot_prune(cfg, params, calib, env, targets=[2.0],
                        search_steps=30, device=dev)
    pruned = res.variants[2.0]

    prompts = next(synthetic_stream(cfg, 4, 24))["tokens"].to(dev)

    @torch.no_grad()
    def bench(p, label, steps=16):
        # Time prefill and decode SEPARATELY and warm: one warm generate
        # runs both paths once, then each phase is measured on its own —
        # never (prefill + decode wall) / decode steps.
        max_len = prompts.shape[1] + steps
        out = generate(cfg, p, prompts, steps=steps)  # reference sample

        serve_prefill(cfg, p, {"tokens": prompts}, max_len)  # warm prefill
        synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = serve_prefill(cfg, p, {"tokens": prompts}, max_len)
        tok = torch.argmax(logits, -1)
        synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3

        # warm decode on a scratch cache: a step consumes the cache it is
        # given
        scratch = serve_prefill(cfg, p, {"tokens": prompts}, max_len)[1]
        serve_step(cfg, p, scratch, tok)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            logits, cache = serve_step(cfg, p, cache, tok)
            tok = torch.argmax(logits, -1)
        synchronize(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        print(f"{label:8s} prefill {prefill_ms:7.2f} ms  "
              f"decode {decode_ms:7.2f} ms/token  sample: "
              f"{out[0, :8].tolist()}")
        return decode_ms

    print("batched serving (4 requests, prefill 24 + 16 new tokens):")
    t_dense = bench(params, "dense")
    t_pruned = bench(pruned.params, "pruned")
    print(f"masked-model decode speedup {t_dense / t_pruned:.2f}x "
          f"(guaranteed-by-table {pruned.speedup:.2f}x; "
          f"shrunk execution adds the rest — see bench table8)")
    return res


if __name__ == "__main__":
    main()
