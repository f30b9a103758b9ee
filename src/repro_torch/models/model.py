"""Model facade: token-level cross-entropy and the LM loss."""
from __future__ import annotations

import torch

from .transformer import forward


def cross_entropy(logits, labels, mask=None):
    """Token-level CE. logits fp32 (B,S,V); labels (B,S); mask (B,S) or None."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(cfg, params, batch):
    """Next-token (decoder) or masked (encoder) LM loss."""
    out = forward(cfg, params, batch["tokens"])
    logits = out["logits"]
    dev = logits.device
    mask = batch.get("mask")
    if cfg.causal:
        logits = logits[:, :-1]
        labels = batch["tokens"][:, 1:]
        mask = mask[:, 1:] if mask is not None else None
    else:
        labels = batch["labels"]
    loss = cross_entropy(logits, labels.to(dev),
                         mask.to(dev) if mask is not None else None)
    out["loss"] = loss + 0.01 * out["aux"]
    return out
