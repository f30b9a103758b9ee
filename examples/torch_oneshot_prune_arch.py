"""One-shot ZipLM pruning of an assigned architecture (reduced config) on
the PyTorch port: the structure registry (GQA groups, SSD heads, MoE
experts) and the per-family latency tables, on the GPU (``--device cpu``
runs the plain PyTorch path). Priced by the cost model on the H100 SXM
data sheet (``runtime.costmodel.H100_SXM``).

  PYTHONPATH=src python examples/torch_oneshot_prune_arch.py --arch mamba2-2.7b
  PYTHONPATH=src python examples/torch_oneshot_prune_arch.py --arch dbrx-132b

``--arch`` takes the assigned architectures the port runs
(``configs.ASSIGNED`` less ``configs.NOT_PORTED``). A model with
cross-attention, encoder/decoder (whisper-large-v3) or grouped cross
layers (llama-3.2-vision-11b), is not shrunk: the example prints its
self layers' kept structures and returns no shrunk model.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import ASSIGNED, NOT_PORTED, smoke_config
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.core.shrink import shrink
from repro_torch.core.structures import registry
from repro_torch.data import calibration_batches
from repro_torch.models import model_init
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
from repro_torch.runtime.device import resolve_device

PORTED = [a for a in ASSIGNED if a not in NOT_PORTED]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b", choices=PORTED)
    ap.add_argument("--target", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch).replace(dtype="float32")
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    mods = registry(cfg)
    kinds = {}
    for m in mods:
        kinds[m.kind] = kinds.get(m.kind, 0) + 1
    print(f"arch={args.arch} (reduced)  prunable modules: {kinds}")

    env = InferenceEnv(batch=8, seq=128, mode="prefill", hw=H100_SXM)
    calib = calibration_batches(cfg, 16, 64, batch=8)
    res = oneshot_prune(cfg, params, calib, env, targets=[args.target],
                        search_steps=25, device=dev)
    v = res.variants[args.target]
    print(f"target {args.target}x -> achieved {v.speedup:.2f}x  "
          f"loss {res.dense_loss:.4f} -> {v.calib_loss:.4f}")
    if cfg.encoder_decoder or cfg.cross_attn_every:
        # shrink refuses it (the pruned runtime has no cross-attention):
        # each self layer's kept structures
        kept_too = ("encoder and cross-attention" if cfg.encoder_decoder
                    else "cross layers")
        for i in range(cfg.num_layers):
            kept = {k: len(res.db[f"L{i}.{k}"].kept_structures(
                v.assignment[f"L{i}.{k}"])) for k in ("attn", "ffn")}
            print(f"  layer {i}: kv_groups={kept['attn']}, "
                  f"d_ff={kept['ffn']} ({kept_too} kept)")
        return res, None
    pm = shrink(cfg, v.params, res.db, v.assignment, device=dev)
    for i, l in enumerate(pm.layers):
        desc = []
        if l.kv_groups:
            desc.append(f"kv_groups={l.kv_groups}")
        if l.ssm_heads:
            desc.append(f"ssd_heads={l.ssm_heads}")
        if l.d_ff:
            desc.append(f"d_ff={l.d_ff}")
        if l.expert_ff:
            desc.append(f"experts={l.expert_ff}")
        print(f"  layer {i}: " + (", ".join(desc) or "fully dropped"))
    return res, pm


if __name__ == "__main__":
    main()
