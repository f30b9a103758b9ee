"""Layer-wise token distillation (paper §3.3, Eq. 5-6).

L = l1*L_task + l2*L_logit + l3*L_token, where L_token is the padding-masked
Euclidean distance between student and teacher per-token hidden vectors,
averaged over all layer boundaries — no manual layer mapping needed because
ZipLM preserves the hidden dimension.
"""
from __future__ import annotations

import torch

from ..models.model import loss_fn
from ..models.transformer import forward


def logit_kl(student_logits, teacher_logits, mask=None):
    """KL(teacher || student) over the vocabulary (Hinton distillation)."""
    t = torch.log_softmax(teacher_logits.float(), dim=-1)
    s = torch.log_softmax(student_logits.float(), dim=-1)
    kl = torch.sum(torch.exp(t) * (t - s), dim=-1)          # (B, S)
    if mask is None:
        return kl.mean()
    mask = mask.to(kl.device, torch.float32)
    return torch.sum(kl * mask) / torch.sum(mask).clamp_min(1.0)


def token_distill(student_hiddens, teacher_hiddens, mask=None):
    """Eq. 6: mean squared Euclidean distance between per-token hidden
    vectors, over non-padded tokens, averaged over layers.

    hiddens: (L, B, S, H).
    """
    d = student_hiddens.float() - teacher_hiddens.float()
    sq = torch.sum(d * d, dim=-1)                            # (L, B, S)
    if mask is None:
        return sq.mean()
    m = mask.to(sq.device, torch.float32)
    nl = sq.shape[0]
    return torch.sum(sq * m[None]) / (nl * torch.sum(m)).clamp_min(1.0)


def distillation_loss(cfg, params, teacher_params, batch, *, l_task=1.0,
                      l_logit=0.0, l_token=0.0):
    """Combined loss; the teacher forward runs without gradients.

    Returns ``(total, metrics)``. The metrics dict always carries the same
    keys (``loss``/``task_loss``/``logit_kl``/``token_l2``, inactive terms
    as 0.0), as the reference's does."""
    need_hiddens = l_token > 0.0
    out = loss_fn(cfg, params, batch, collect_hiddens=need_hiddens)
    dev = out["logits"].device
    total = l_task * out["loss"]
    metrics = {"task_loss": out["loss"],
               "logit_kl": torch.zeros((), device=dev),
               "token_l2": torch.zeros((), device=dev)}
    if teacher_params is not None and (l_logit > 0.0 or l_token > 0.0):
        with torch.no_grad():
            t_out = forward(cfg, teacher_params, batch["tokens"],
                            frontend_embeds=batch.get("frontend"),
                            collect_hiddens=need_hiddens)
        mask = batch.get("mask")
        if l_logit > 0.0:
            if cfg.causal:
                kl = logit_kl(out["logits"][:, :-1], t_out["logits"][:, :-1],
                              mask[:, 1:] if mask is not None else None)
            else:
                kl = logit_kl(out["logits"], t_out["logits"], mask)
            total = total + l_logit * kl
            metrics["logit_kl"] = kl
        if l_token > 0.0:
            tok = token_distill(out["hiddens"], t_out["hiddens"], mask)
            total = total + l_token * tok
            metrics["token_l2"] = tok
    metrics["loss"] = total
    return total, metrics
