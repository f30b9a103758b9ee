"""Serving launcher: a thin CLI over the continuous-batching engine
(``repro_torch.serve``) with warm, separate metrics: prefill latency and
per-decode-token latency are reported apart, after a warm-up pass.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
      --slots 4 --requests 16 --max-len 64

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path instead.
Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse

from ..configs import GPT2_SMALL

ARCHS = {"gpt2-small": GPT2_SMALL}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--max-len", type=int, default=64,
                    help="KV-cache capacity (prompt + generation)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..models import model_init
    from ..serve import DenseServeModel, ServeEngine, synthetic_requests

    cfg = ARCHS[args.arch]
    params = model_init(cfg, torch.Generator().manual_seed(0),
                        device=args.device)
    prompt_lens = tuple(p for p in (8, 12, 16, 24) if p < args.max_len)
    engine = ServeEngine(DenseServeModel(cfg, params, args.max_len),
                         num_slots=args.slots)
    engine.warmup(prompt_lens)
    reqs = synthetic_requests(cfg, args.requests, seed=0, rate=args.rate,
                              prompt_lens=prompt_lens,
                              steps_range=(4, max(4, args.max_len // 4)))
    report = engine.run(reqs)
    m = report.as_dict()
    print(f"[serve] {cfg.name} on {args.device}: {m['requests']} requests, "
          f"{m['total_tokens']} tokens, {args.slots} slots")
    print(f"  prefill         {m['prefill_ms_mean']:8.2f} ms (warm, mean)")
    print(f"  decode          {m['decode_ms_per_token_mean']:8.2f} ms/token "
          f"(warm, mean)")
    print(f"  request latency p50={m['p50_ms']:.1f} ms "
          f"p99={m['p99_ms']:.1f} ms")
    print(f"  throughput      {m['tokens_per_s']:8.1f} tokens/s")
    print("sample:", report.records[0].tokens[:8])
    return m


if __name__ == "__main__":
    main()
