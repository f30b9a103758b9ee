"""Primitive layers: norms, rotary embeddings, embeddings, initializers.

Parameters are nested dicts of tensors laid out as in the JAX package
(``y = x @ W``; stacked per-layer leaves carry a leading layer axis), so
``models.convert`` moves weights between the two without reshaping.
"""
from __future__ import annotations

import math

import torch


def compute_dtype(cfg) -> torch.dtype:
    """Activation/compute dtype for ``cfg`` ("float32", "bfloat16", or
    ``"mixed_<dtype>"`` — fp32 master params with ``<dtype>`` compute)."""
    d = cfg.dtype
    if d.startswith("mixed_"):
        d = d[len("mixed_"):]
    dt = getattr(torch, d, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


def dense_init(shape, generator: torch.Generator, in_axis: int = -2
               ) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init in fp32, drawn on the
    generator's device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std)


def norm_init(cfg, nlayers: int = 0):
    shape = (nlayers, cfg.d_model) if nlayers else (cfg.d_model,)
    p = {"scale": torch.ones(shape)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape)
    return p


def apply_norm(cfg, p, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                             + cfg.norm_eps)
        y = y * p["scale"]
    return y.to(out_dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=x.device) / head_dim))
    angles = positions[..., :, None].float() * freqs       # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embedding_init(cfg, generator: torch.Generator):
    p = {"table": dense_init((cfg.vocab_size, cfg.d_model), generator,
                             in_axis=-1)}
    if cfg.pos_emb == "learned":
        p["pos"] = dense_init((cfg.max_position, cfg.d_model), generator,
                              in_axis=-1)
    return p


def embed_tokens(cfg, p, tokens: torch.Tensor, positions=None
                 ) -> torch.Tensor:
    """Token (+ learned position) embeddings; ``positions`` defaults to
    ``0..S-1`` (decode passes each row's absolute position). A position
    past the table reads NaN, as the reference's ``jnp.take`` does: an
    idle serving slot is decoded with the others and its position runs
    on, and its row is never read."""
    x = p["table"][tokens].to(compute_dtype(cfg))
    if cfg.pos_emb == "learned":
        table = p["pos"]
        if positions is None:
            pe = table[:tokens.shape[-1]]
        else:
            n = table.shape[0]
            pe = torch.where((positions < n)[..., None],
                             table[positions.clamp(max=n - 1)], float("nan"))
        x = x + pe.to(x.dtype)
    return x


def unembed(cfg, emb_p, head_p, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states back to vocabulary logits (fp32)."""
    w = emb_p["table"] if cfg.tie_embeddings else head_p["w"]
    return (x @ w.to(x.dtype).T).float()


_F32_LEAVES = {"scale", "bias"}  # norm parameters stay fp32


def cast_params(tree, dtype: torch.dtype):
    """A copy of a params tree (nested dicts, lists and ``None``) with its
    matmul weights, biases and embeddings in ``dtype`` and its norm
    parameters left fp32. Every op already casts its weights to the
    compute dtype, so running on the cast tree gives the same values;
    casting once saves the per-call casts (the reference casts the layer
    stack once per forward, ``_cast_layer_params``)."""
    def cast(node, key=""):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        if node is None or key in _F32_LEAVES \
                or not torch.is_floating_point(node):
            return node
        return node.to(dtype)
    return cast(tree)
