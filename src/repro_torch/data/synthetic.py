"""Deterministic synthetic data: a Zipfian Markov token stream.

The streams are numpy-seeded exactly as in the JAX package, so the port
and the reference see bit-identical tokens. Batches are CPU tensors;
the model's entry points move them to their device.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from ..models.layers import compute_dtype


def _markov_table(vocab: int, seed: int, branch: int = 8) -> np.ndarray:
    """Sparse-ish row-stochastic transition table (vocab, branch) targets."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch))


def synthetic_tokens(vocab: int, batch: int, seq: int, *, seed: int = 0,
                     step: int = 0, corpus_seed: int = 0) -> np.ndarray:
    """One deterministic batch of Markov-Zipf tokens (B, S), int64.

    ``seed``/``step`` vary the samples; the transition table (the
    "corpus") is fixed by ``corpus_seed``.
    """
    rng = np.random.default_rng(seed * 1_000_003 + step)
    table = _markov_table(vocab, corpus_seed)
    branch = table.shape[1]
    # Zipfian choice among branches makes low-index branches dominate
    p = 1.0 / np.arange(1, branch + 1)
    p /= p.sum()
    out = np.empty((batch, seq), np.int64)
    cur = rng.integers(0, vocab, size=batch)
    for t in range(seq):
        out[:, t] = cur
        choice = rng.choice(branch, size=batch, p=p)
        cur = table[cur, choice]
        # occasional random restart to keep entropy up
        restart = rng.random(batch) < 0.02
        cur[restart] = rng.integers(0, vocab, size=int(restart.sum()))
    return out


def make_batch_np(cfg, batch: int, seq: int, *, seed: int = 0,
                  step: int = 0) -> Dict[str, torch.Tensor]:
    """A token batch (plus masked-LM labels/mask for encoders, and the
    stub frontend's frame embeddings (B, T, F) in the compute dtype for
    an audio encoder/decoder or a vision cross-attention model, drawn as
    the reference draws them)."""
    if cfg.frontend not in ("none", "audio_stub", "vision_stub"):
        raise NotImplementedError(
            f"frontend {cfg.frontend!r}: only the audio and vision stubs' "
            "frame embeddings are ported")
    tokens = synthetic_tokens(cfg.vocab_size, batch, seq, seed=seed,
                              step=step)
    b = {"tokens": torch.from_numpy(tokens)}
    if not cfg.causal:
        b["labels"] = b["tokens"]
        rng = np.random.default_rng(seed * 7 + step)
        mask = rng.random((batch, seq)) < 0.15
        masked = tokens.copy()
        masked[mask] = 0  # [MASK]
        b["tokens"] = torch.from_numpy(masked)
        b["mask"] = torch.from_numpy(mask)
    if cfg.frontend != "none":
        rng = np.random.default_rng(seed * 13 + step)
        b["frontend"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_frontend_tokens, cfg.frontend_dim))).to(
                compute_dtype(cfg))
    return b


def synthetic_stream(cfg, batch: int, seq: int, *, seed: int = 0,
                     start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless training batches ``make_batch_np(..., step=start_step + i)``:
    a run resumed at step ``k`` reads the same batches from ``k`` on."""
    step = start_step
    while True:
        yield make_batch_np(cfg, batch, seq, seed=seed, step=step)
        step += 1


def calibration_batches(cfg, n_samples: int, seq: int, *, batch: int = 8,
                        seed: int = 1234) -> List[Dict[str, torch.Tensor]]:
    """n_samples calibration sequences in batches (paper: 512-2048 samples)."""
    out = []
    done = 0
    step = 0
    while done < n_samples:
        b = min(batch, n_samples - done)
        out.append(make_batch_np(cfg, b, seq, seed=seed, step=10_000 + step))
        done += b
        step += 1
    return out
