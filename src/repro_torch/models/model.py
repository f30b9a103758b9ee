"""Model facade: token-level cross-entropy, the LM loss, and the serving
calls (prefill, one decode step, sampling, and the ``generate`` loop that
is the serving engine's oracle)."""
from __future__ import annotations

from typing import Optional

import torch

from .transformer import decode_step, forward, init_cache


def cross_entropy(logits, labels, mask=None):
    """Token-level CE. logits fp32 (B,S,V); labels (B,S); mask (B,S) or None."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(cfg, params, batch, *, collect_hiddens=False):
    """Next-token (decoder) or masked (encoder) LM loss."""
    out = forward(cfg, params, batch["tokens"],
                  frontend_embeds=batch.get("frontend"),
                  collect_hiddens=collect_hiddens)
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


def serve_prefill(cfg, params, batch, max_len: Optional[int] = None):
    """Prefill: a full forward that also fills the decode cache. Returns
    (last-position logits (B,1,V), cache).

    ``max_len`` sizes the KV cache (an SSM stack's state does not grow
    with it); callers that know their generation
    length pass ``prompt_len + steps`` (``generate`` does), and the
    default of twice the prompt is only headroom. Decoding past the
    cache's capacity would clamp the write index to the last slot and
    corrupt every later token, so ``generate`` and the serving engine
    raise before stepping past it.
    """
    b, s = batch["tokens"].shape
    max_len = max_len or 2 * s
    out = forward(cfg, params, batch["tokens"],
                  frontend_embeds=batch.get("frontend"), mode="prefill")
    cache = assemble_prefill_cache(cfg, out, b, s, max_len)
    return out["logits"][:, -1:], cache


def assemble_prefill_cache(cfg, out, batch: int, s: int, max_len: int):
    """The decode cache built from a prefill ``forward`` output, on the
    device of its logits. Shared by ``serve_prefill`` and the serving
    engine (which prefills at a padded bucket length)."""
    cache = init_cache(cfg, batch, max_len, device=out["logits"].device)
    if "cache" in out:
        pre = out["cache"]  # (L,B,Sc,HKV,D), ring-rolled for sliding windows
        sc = cache["attn"]["k"].shape[2]
        if pre["k"].shape[2] >= sc:  # a sliding-window ring already full
            cache["attn"] = {"k": pre["k"][:, :, :sc].contiguous(),
                             "v": pre["v"][:, :, :sc].contiguous()}
        else:
            n = pre["k"].shape[2]
            cache["attn"]["k"][:, :, :n] = pre["k"]
            cache["attn"]["v"][:, :, :n] = pre["v"]
    if "cache_ssm" in out:  # the SSD state and conv tails after the prompt
        cache["ssm"] = out["cache_ssm"]
    if "cross_kv" in out:  # the decoder layers' keys/values of the encoder
        cache["cross"] = out["cross_kv"]
    if "frontend_kv" in out:  # each cross group's keys/values of the frames
        cache["cross"] = out["frontend_kv"]
    cache["pos"].fill_(s)
    return cache


def serve_step(cfg, params, cache, tokens):
    """One new token against an existing cache (updated in place)."""
    return decode_step(cfg, params, cache, tokens)


def sample_token(logits, generator: Optional[torch.Generator] = None, *,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Next token (B,1) from (B,1,V) logits: greedy without a generator,
    else sampled from ``softmax(logits / temperature)``, restricted to
    the ``top_k`` largest when ``top_k > 0``. The generator must live on
    the logits' device; the draw is a Gumbel-max, as the reference's
    ``jax.random.categorical``, so ``top_k=1`` is greedy."""
    if generator is None:
        return logits.argmax(dim=-1)
    scaled = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    noise = torch.empty_like(scaled).exponential_(generator=generator)
    return (scaled - noise.log()).argmax(dim=-1)


def generate(cfg, params, prompt, steps: int, *, frontend=None,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, top_k: int = 0,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Generation loop (the serving engine's oracle): (B, S) prompt ->
    (B, steps) tokens on the params' device.

    Greedy without a generator; temperature/top-k sampling with one
    (deterministic in its seed). An encoder/decoder or grouped
    cross-attention model takes the prompts' ``frontend`` frame
    embeddings (B, T, F); the prefill keeps the cross-attention keys and
    values in the cache. The KV cache is sized ``prompt_len +
    steps`` by default; an explicit smaller ``max_len`` raises instead of
    clamping the cache's write index.
    """
    s = prompt.shape[1]
    if max_len is None:
        max_len = s + steps
    if s + steps > max_len:
        raise RuntimeError(
            f"generation overflows the KV cache: prompt_len={s} + "
            f"steps={steps} > max_len={max_len}; decoding past capacity "
            "would overwrite the last cache slot and corrupt output")
    kw = {"temperature": temperature, "top_k": top_k}
    with torch.no_grad():
        batch = {"tokens": prompt}
        if frontend is not None:
            batch["frontend"] = frontend
        logits, cache = serve_prefill(cfg, params, batch, max_len=max_len)
        tok = sample_token(logits, generator, **kw)
        outs = [tok]
        for _ in range(steps - 1):
            logits, cache = serve_step(cfg, params, cache, tok)
            tok = sample_token(logits, generator, **kw)
            outs.append(tok)
    return torch.cat(outs, dim=1)
