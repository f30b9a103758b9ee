"""Slot-based continuous-batching engine over prefill and decode steps.

See the package docstring (``repro_torch.serve``) for the slot lifecycle
and the cache sizing contract. Two model adapters share one engine:

* :class:`DenseServeModel`: stock params, ``transformer.decode_step``
  over the stacked cache;
* :class:`PrunedServeModel`: a ZipLM-shrunk :class:`PrunedModel`,
  ``models.pruned.decode_step_pruned`` over the per-layer cache (KV bytes
  follow the shrunk structure).

Both hold their weights cast once to the compute dtype (the ops would
cast them on every call to the same values), and both prefill through
the flash path whatever the config's ``attn_impl`` says: on the card
every served prompt goes through the hand-written flash-attention
kernel (a CPU tensor takes its plain version).

A decode step passes the ``serve.step`` fault site and is retried at most
``_STEP_RETRIES`` times: an injected failure, or non-finite logits on an
active slot, is counted in the ambient report and the step recomputed
from the cache it was given. The caches' k/v are updated in place, but a
step writes only row ``pos`` of each slot (an idle slot past the cache,
its last row), from that slot's token, position and earlier rows, none
of which an attempt changes: a recomputed step writes the rows it wrote
before with the same values. The positions advance (``pos + 1`` in the
cache a step returns) only when a step succeeds. A prefill's non-finite
logits raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..models.layers import cast_params, compute_dtype
from ..models.model import assemble_prefill_cache
from ..models.pruned import (PrunedLayer, PrunedModel, _check_decodable,
                             decode_step_pruned, init_cache_pruned,
                             prefill_pruned)
from ..models.transformer import decode_step, forward, init_cache
from ..robustness import faults
from ..robustness.report import current_report
from .workload import Request

# attempts of one decode step before the engine gives up
_STEP_RETRIES = 4


def _bucket(s: int, max_len: int) -> int:
    """Next power-of-two prompt bucket (>= 8), capped at max_len: bounds
    the number of distinct prefill shapes under mixed prompt lengths."""
    b = 8
    while b < s:
        b *= 2
    return min(b, max_len)


def _kv_bytes(cache) -> int:
    """KV bytes of a slot cache (the stacked dense form or the pruned
    per-layer list, whose ``None`` entries cost nothing)."""
    attn = cache["attn"]
    bufs = attn if isinstance(attn, list) else [attn]
    return sum(t.numel() * t.element_size()
               for buf in bufs if buf is not None for t in buf.values())


def _padded(tokens: np.ndarray, bucket: int, device) -> torch.Tensor:
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :tokens.shape[0]] = tokens
    return torch.from_numpy(padded).to(device)


def _serving_cfg(cfg):
    """The config a serving adapter runs: ``cfg`` with flash prefill."""
    if not cfg.causal or cfg.attention != "full" or cfg.frontend != "none":
        raise NotImplementedError(
            "serving engine covers causal full-attention text decoders")
    _check_decodable(cfg)
    return cfg.replace(attn_impl="flash_lax")


class DenseServeModel:
    """Engine adapter for stock (unpruned) params."""

    def __init__(self, cfg, params, max_len: int):
        self.cfg, self.max_len = _serving_cfg(cfg), max_len
        self.params = cast_params(params, compute_dtype(cfg))
        self.device = params["embed"]["table"].device

    def init_slots(self, nslots: int):
        return init_cache(self.cfg, nslots, self.max_len, per_slot=True,
                          device=self.device)

    def prefill(self, tokens: np.ndarray):
        """(s,) prompt -> (last-token logits (1,1,V), single-row cache).

        Runs at the padded bucket length; rows past the true length hold
        garbage k/v but are never attended (the causal mask during
        prefill; during decode every position <= pos has been overwritten
        by a real token before the mask admits it).
        """
        s = int(tokens.shape[0])
        bucket = _bucket(s, self.max_len)
        out = forward(self.cfg, self.params,
                      _padded(tokens, bucket, self.device), mode="prefill")
        cache = assemble_prefill_cache(self.cfg, out, 1, bucket,
                                       self.max_len)
        return out["logits"][:, s - 1:s], cache

    def insert(self, cache, row, slot: int, pos: int):
        """Copy a prefilled row into ``slot`` (in place)."""
        cache["pos"][slot] = pos
        for key in ("k", "v"):
            cache["attn"][key][:, slot] = row["attn"][key][:, 0]
        return cache

    def step(self, cache, tokens):
        return decode_step(self.cfg, self.params, cache, tokens)


class PrunedServeModel:
    """Engine adapter for a ZipLM-shrunk :class:`PrunedModel`."""

    def __init__(self, pm: PrunedModel, max_len: int):
        cfg = _serving_cfg(pm.cfg)
        dt = compute_dtype(cfg)
        self.pm = PrunedModel(
            cfg=cfg, globals_=cast_params(pm.globals_, dt),
            layers=[PrunedLayer(kv_groups=l.kv_groups, d_ff=l.d_ff,
                                ssm_heads=l.ssm_heads,
                                expert_ff=list(l.expert_ff),
                                params=cast_params(l.params, dt))
                    for l in pm.layers])
        self.cfg, self.max_len = cfg, max_len
        self.device = pm.globals_["embed"]["table"].device

    def init_slots(self, nslots: int):
        return init_cache_pruned(self.pm, nslots, self.max_len,
                                 per_slot=True)

    def prefill(self, tokens: np.ndarray):
        s = int(tokens.shape[0])
        bucket = _bucket(s, self.max_len)
        logits, cache = prefill_pruned(
            self.pm, _padded(tokens, bucket, self.device), self.max_len,
            full_logits=True)
        return logits[:, s - 1:s], cache

    def insert(self, cache, row, slot: int, pos: int):
        cache["pos"][slot] = pos
        for buf, rbuf in zip(cache["attn"], row["attn"]):
            if buf is not None:
                for key in ("k", "v"):
                    buf[key][slot] = rbuf[key][0]
        return cache

    def step(self, cache, tokens):
        return decode_step_pruned(self.pm, cache, tokens)


@dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    steps: int
    arrival: float
    latency_class: str
    tokens: List[int] = field(default_factory=list)
    prefill_ms: float = 0.0
    decode_step_ms: List[float] = field(default_factory=list)
    finish: float = 0.0           # virtual seconds since stream start

    @property
    def latency_s(self) -> float:
        """Queueing + service time of the whole request."""
        return self.finish - self.arrival

    @property
    def decode_ms_per_token(self) -> float:
        return float(np.mean(self.decode_step_ms)) \
            if self.decode_step_ms else 0.0


@dataclass
class ServeReport:
    records: List[RequestRecord]
    wall_s: float                 # busy wall-clock (prefills + steps)
    steps: int                    # decode steps executed
    kv_cache_bytes: int

    @property
    def total_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.records)

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-12)

    def latency_percentiles(self, qs=(50, 99)) -> Dict[str, float]:
        lats = [r.latency_s * 1e3 for r in self.records]
        return {f"p{q}_ms": float(np.percentile(lats, q)) for q in qs}

    @property
    def prefill_ms_mean(self) -> float:
        return float(np.mean([r.prefill_ms for r in self.records]))

    @property
    def decode_ms_per_token_mean(self) -> float:
        return float(np.mean([r.decode_ms_per_token
                              for r in self.records if r.decode_step_ms]))

    def as_dict(self) -> Dict[str, Any]:
        d = {"requests": len(self.records),
             "total_tokens": self.total_tokens,
             "tokens_per_s": self.tokens_per_s,
             "wall_s": self.wall_s,
             "prefill_ms_mean": self.prefill_ms_mean,
             "decode_ms_per_token_mean": self.decode_ms_per_token_mean,
             "kv_cache_bytes": self.kv_cache_bytes}
        d.update(self.latency_percentiles())
        return d


class ServeEngine:
    """Continuous batching over ``num_slots`` decode slots.

    ``clock`` is injectable (tests script it) and is read around each
    prefill and decode step only, after the host has pulled the step's
    logits, so measured latencies are the device work (plus its launch),
    not the host bookkeeping. Call :meth:`warmup` before timing runs.
    A profiler sees each timed step as the range ``serve.prefill`` or
    ``serve.decode``.
    """

    def __init__(self, model, num_slots: int = 4,
                 clock: Callable[[], float] = time.perf_counter):
        self.model = model
        self.num_slots = num_slots
        self.clock = clock
        self.cache = model.init_slots(num_slots)
        self.kv_cache_bytes = _kv_bytes(self.cache)
        self.max_len = model.max_len

    @torch.no_grad()
    def warmup(self, prompt_lens=(8,)):
        """Run each prompt length's prefill bucket, an insert and a decode
        step once, on a scratch cache (self.cache is never touched)."""
        cache = self.model.init_slots(self.num_slots)
        toks = torch.zeros((self.num_slots, 1), dtype=torch.long,
                           device=self.model.device)
        for s in prompt_lens:
            s = min(int(s), self.max_len - 1)
            _, row = self.model.prefill(np.zeros((s,), np.int64))
            cache = self.model.insert(cache, row, 0, s)
            logits, cache = self.model.step(cache, toks)
            # sync: warm-up barrier
            logits.cpu()

    def _step(self, tokens: np.ndarray, active_slots: List[int]):
        """One batched decode step through the ``serve.step`` fault site,
        recomputed after a failed attempt (module docstring); returns the
        host logits. ``self.cache`` takes the step's cache only when an
        attempt succeeds."""
        rep = current_report()
        toks = torch.from_numpy(tokens.reshape(-1, 1)).to(self.model.device)
        for attempt in range(_STEP_RETRIES):
            try:
                poison = faults.poison_scalar("serve.step")
            except faults.INJECTED:
                rep.count("detected", "serve.step")
                rep.count("retries", "serve.step")
                continue
            logits, cache = self.model.step(self.cache, toks)
            if poison != 1.0:  # an injected fault: poison the logits
                logits = logits * poison
            # sync: one pull per decode step (on the card the synchronize
            # that ends a timed step); greedy sampling and the finite
            # check both need the host logits
            lg = logits.float().cpu().numpy()
            if not np.isfinite(lg[active_slots]).all():
                rep.count("detected", "serve.step")
                rep.count("retries", "serve.step")
                continue
            if attempt:
                rep.count("recovered", "serve.step")
            self.cache = cache
            return lg
        raise RuntimeError(
            f"serve.step failed {_STEP_RETRIES} times in a row: the fault "
            "is not transient")

    @torch.no_grad()
    def run(self, requests: List[Request]) -> ServeReport:
        """Serve a request stream to completion; returns per-request and
        aggregate metrics.

        Time is virtual: it advances by the measured wall-clock of each
        prefill and decode step and jumps across idle gaps to the next
        arrival, so a seeded Poisson stream gives deterministic tokens
        and reproducible latency structure.
        """
        for r in requests:
            if r.prompt_len + r.steps > self.max_len:
                raise RuntimeError(
                    f"request {r.rid} overflows the KV cache: prompt_len="
                    f"{r.prompt_len} + steps={r.steps} > max_len="
                    f"{self.max_len}; decoding past capacity would "
                    "overwrite the last cache slot and corrupt output")
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        records = {r.rid: RequestRecord(
            rid=r.rid, prompt_len=r.prompt_len, steps=r.steps,
            arrival=r.arrival, latency_class=r.latency_class)
            for r in requests}
        free = list(range(self.num_slots - 1, -1, -1))
        active: Dict[int, RequestRecord] = {}
        last_tok = np.zeros(self.num_slots, np.int64)
        remaining: Dict[int, int] = {}
        t = 0.0
        busy = 0.0
        nsteps = 0

        while pending or active:
            # admit arrived requests into free slots (prefill + insert)
            while pending and free and pending[0].arrival <= t:
                req = pending.pop(0)
                slot = free.pop()
                t0 = self.clock()
                with record_function("serve.prefill"):
                    logits, row = self.model.prefill(req.tokens)
                    self.cache = self.model.insert(self.cache, row, slot,
                                                   req.prompt_len)
                    # sync: one pull per admission; the first token gates
                    # whether the request enters the decode batch at all
                    lg = logits.float().cpu().numpy()
                    if not np.isfinite(lg).all():
                        raise FloatingPointError(
                            f"prefill of request {req.rid} produced "
                            "non-finite logits")
                tok = int(np.argmax(lg[0, 0]))
                dt = self.clock() - t0
                t += dt
                busy += dt
                rec = records[req.rid]
                rec.prefill_ms = dt * 1e3
                rec.tokens.append(tok)
                last_tok[slot] = tok
                if req.steps > 1:
                    active[slot] = rec
                    remaining[slot] = req.steps - 1
                else:
                    rec.finish = t
                    free.append(slot)

            if not active:
                if pending:
                    t = max(t, pending[0].arrival)
                continue

            # one batched decode step over all slots
            slots = sorted(active)
            t0 = self.clock()
            with record_function("serve.decode"):
                lg = self._step(last_tok, slots)
            dt = self.clock() - t0
            t += dt
            busy += dt
            nsteps += 1
            for slot in slots:
                tok = int(np.argmax(lg[slot, 0]))
                rec = active[slot]
                rec.tokens.append(tok)
                rec.decode_step_ms.append(dt * 1e3)
                last_tok[slot] = tok
                remaining[slot] -= 1
                if remaining[slot] == 0:
                    rec.finish = t
                    del active[slot]
                    del remaining[slot]
                    free.append(slot)

        return ServeReport(records=[records[r.rid] for r in requests],
                           wall_s=busy, steps=nsteps,
                           kv_cache_bytes=self.kv_cache_bytes)
