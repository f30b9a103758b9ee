"""Analytic roofline cost model of a prunable module's runtime.

Per-module time is ``max(FLOPs / peak, bytes / memory rate) +
op_overhead``, with matrix dimensions rounded up to the (8, 128) tile of
the hardware the reference priced (``matmul_time``). Every ``InferenceEnv``
names its ``HardwareSpec`` explicitly (there is no default), and an env
without one (``hw=None``) can only be timed by the measured backend.
``H100_SXM`` is the port's counterpart of the reference's ``TPU_V5E``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float       # FLOP/s per chip
    hbm_bw: float           # bytes/s per chip
    ici_bw: float           # bytes/s per link
    hbm_bytes: float
    op_overhead: float      # seconds per fused op (dispatch/latency floor)


# the H100 SXM data sheet at 700 W: dense bf16 tensor-core peak, HBM3
# rate, 80 GB; no interconnect on one card. The 5e-6 s a module, a floor
# for an eager launch, is an assumption, not a measurement, and the
# speedups it gives are the model's, not measured ones
H100_SXM = HardwareSpec("h100-sxm-datasheet", peak_flops=989e12,
                        hbm_bw=3.35e12, ici_bw=0.0, hbm_bytes=80e9,
                        op_overhead=5e-6)


@dataclass(frozen=True, kw_only=True)
class InferenceEnv:
    """The paper's 'inference specification': batch, sequence, regime,
    and the hardware the analytic model prices (None: measure only)."""
    batch: int
    seq: int
    hw: Optional[HardwareSpec]
    mode: str = "prefill"          # prefill | decode | train
    tp: int = 1                    # tensor-parallel degree (chips)

    @property
    def tokens(self) -> int:
        return self.batch * (1 if self.mode == "decode" else self.seq)

    def replace(self, **kw) -> "InferenceEnv":
        return dataclasses.replace(self, **kw)


def _hw(env: InferenceEnv) -> HardwareSpec:
    if env.hw is None:
        raise ValueError("this InferenceEnv has no HardwareSpec: the "
                         "analytic cost model needs one (or use the "
                         "'measure' latency backend)")
    return env.hw


def _rup(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def matmul_time(env: InferenceEnv, m: int, k: int, n: int,
                bytes_per_el: int = 2) -> float:
    """Time of an (m,k)x(k,n) matmul on one chip of the env."""
    if m == 0 or k == 0 or n == 0:
        return 0.0
    hw = _hw(env)
    flops_eff = 2.0 * _rup(m, 8) * _rup(k, 128) * _rup(n, 128)
    t_c = flops_eff / hw.peak_flops
    bytes_ = (m * k + k * n + m * n) * bytes_per_el
    t_m = bytes_ / hw.hbm_bw
    return max(t_c, t_m) + hw.op_overhead


def allreduce_time(env: InferenceEnv, bytes_: float) -> float:
    if env.tp <= 1:
        return 0.0
    hw = _hw(env)
    return 2.0 * bytes_ * (env.tp - 1) / env.tp / hw.ici_bw + hw.op_overhead


def attn_time(cfg, env: InferenceEnv, kv_groups: int) -> float:
    """Attention block with `kv_groups` of num_kv_heads groups remaining."""
    if kv_groups == 0:
        return 0.0
    hw = _hw(env)
    dh = cfg.resolved_head_dim
    hq = kv_groups * cfg.q_per_kv
    hkv = kv_groups
    d = cfg.d_model
    t_tok = env.tokens
    tp = env.tp
    # projections (TP-sharded over heads)
    t = matmul_time(env, t_tok, d, math.ceil(hq * dh / tp))
    t += 2 * matmul_time(env, t_tok, d, math.ceil(hkv * dh / tp))
    t += matmul_time(env, t_tok, math.ceil(hq * dh / tp), d)
    # attention einsums
    hq_loc = max(1, hq // tp)
    if env.mode == "decode":
        # memory-bound KV read + small matmuls
        kv_bytes = 2 * env.seq * (hkv / min(tp, max(hkv, 1))) * dh \
            * env.batch * 2
        t += max(4.0 * env.batch * hq_loc * env.seq * dh / hw.peak_flops,
                 kv_bytes / hw.hbm_bw) + 2 * hw.op_overhead
    else:
        s = env.seq
        ctx = min(s, cfg.window_size) if cfg.attention == "sliding_window" \
            else s
        flops = 4.0 * env.batch * hq_loc * s * ctx * dh
        t += flops / hw.peak_flops + 2 * hw.op_overhead
    t += allreduce_time(env, t_tok * d * 2)
    return t


def ffn_time(cfg, env: InferenceEnv, f_live: int,
             tokens: Optional[float] = None) -> float:
    if f_live == 0:
        return 0.0
    d = cfg.d_model
    t_tok = tokens if tokens is not None else env.tokens
    n_mat = 3 if cfg.ffn_activation == "swiglu" else 2
    f_loc = math.ceil(f_live / env.tp)
    t = (n_mat - 1) * matmul_time(env, int(t_tok), d, f_loc)
    t += matmul_time(env, int(t_tok), f_loc, d)
    t += allreduce_time(env, t_tok * d * 2)
    return t


def moe_expert_time(cfg, env: InferenceEnv, f_live: int) -> float:
    """One expert's FFN at the expected per-expert token count, each
    expert on one chip (expert parallelism across the env's tp)."""
    c = env.tokens * cfg.num_experts_per_tok / cfg.num_experts * 1.25
    return ffn_time(cfg.replace(num_experts=0), env.replace(tp=1),
                    f_live, tokens=max(1.0, c))


def ssm_time(cfg, env: InferenceEnv, heads: int) -> float:
    """Mamba-2 block with ``heads`` of its SSD heads remaining: the input
    and output projections, and the recurrent state (decode) or the
    chunked scan (prefill/train)."""
    if heads == 0:
        return 0.0
    hw = _hw(env)
    d = cfg.d_model
    hp = cfg.ssm_head_dim
    di = heads * hp
    n = cfg.ssm_state
    t_tok = env.tokens
    t = matmul_time(env, t_tok, d, math.ceil((2 * di + 2 * n + heads) / env.tp))
    t += matmul_time(env, t_tok, math.ceil(di / env.tp), d)
    if env.mode == "decode":
        state_bytes = env.batch * heads * hp * n * 4 * 2
        t += state_bytes / hw.hbm_bw + hw.op_overhead
    else:
        q = cfg.ssm_chunk
        flops = 2.0 * t_tok * q * (heads / env.tp) * (hp + n) \
            + 4.0 * t_tok * (heads / env.tp) * hp * n
        t += flops / hw.peak_flops + 4 * hw.op_overhead
    t += allreduce_time(env, t_tok * d * 2)
    return t


def base_time(cfg, env: InferenceEnv) -> float:
    """Unprunable remainder: embeddings, norms, logits head."""
    hw = _hw(env)
    d, v = cfg.d_model, cfg.vocab_size
    t_tok = env.tokens
    t = matmul_time(env, t_tok, d, math.ceil(v / env.tp))  # logits
    t += allreduce_time(env, t_tok * 4)                    # softmax combine
    norm_bytes = 2 * cfg.num_layers * t_tok * d * 2 * 2
    t += norm_bytes / hw.hbm_bw + 2 * cfg.num_layers * hw.op_overhead
    return t
