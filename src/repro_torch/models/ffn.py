"""Dense feed-forward blocks: SwiGLU (llama-family) and GELU MLP (BERT/GPT2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init


def ffn_init(cfg, generator: torch.Generator, nlayers: int):
    d, f = cfg.d_model, cfg.d_ff
    pfx = (nlayers,)
    if cfg.ffn_activation == "swiglu":
        return {"wg": dense_init(pfx + (d, f), generator),
                "wu": dense_init(pfx + (d, f), generator),
                "wd": dense_init(pfx + (f, d), generator)}
    return {"wi": dense_init(pfx + (d, f), generator),
            "bi": torch.zeros(pfx + (f,)),
            "wd": dense_init(pfx + (f, d), generator),
            "bd": torch.zeros(pfx + (d,))}


def ffn_apply(cfg, p, x, capture=None):
    """Writes the down-projection input to ``capture["wd_in"]``."""
    dt = x.dtype
    if cfg.ffn_activation == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    if capture is not None:
        capture["wd_in"] = h
    y = h @ p["wd"].to(dt)
    if "bd" in p:
        y = y + p["bd"].to(dt)
    return y
