"""Model configuration dataclass (the port's own copy of ``ModelConfig``).

The fields mirror the JAX package's ``ModelConfig``, apart from the
options that choose how the JAX program is traced or tiled (``remat``,
``scan_layers``, ``flash_block_q``, ``flash_block_k``): the port runs a
Python loop of layers, and its flash kernel tiles by 64. ``attn_impl``
chooses the attention of a full-sequence forward as the reference's
``_select_impl`` does (``models.attention``): ``"flash_lax"`` runs the
flash path (the hand-written flash-attention kernel on the card),
``"auto"`` runs it only when the query and key lengths both exceed 2048,
and every other value, ``"flash_pallas"`` included, runs dense attention.
The serving engine's prefill takes the flash path whatever it says
(``serve.engine``). The port's forward runs dense self-attention stacks,
mixture-of-experts stacks and Mamba-2 (SSD) stacks; ``models.transformer``
rejects the families it does not run yet.

``ShapeConfig`` and ``LM_SHAPES`` are the reference's input-shape cells,
which ``configs.shapes_for`` assigns to an architecture. ``MeshConfig``
is the reference's mesh and sharding-profile configuration, and
``TrainConfig`` its trainer configuration, field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention ---
    attention: str = "full"  # full | sliding_window | none
    window_size: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True

    # --- ffn ---
    ffn_activation: str = "swiglu"  # swiglu | gelu

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_prune_unit: str = "width"

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- hybrid (parallel attn + ssm heads, Hymba-style) ---
    hybrid: bool = False

    # --- encoder/decoder & multimodal ---
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_attn_every: int = 0
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_frontend_tokens: int = 0
    frontend_dim: int = 0

    # --- norms / embeddings ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos_emb: str = "rope"  # rope | learned | none
    max_position: int = 1 << 20
    tie_embeddings: bool = True
    norm_eps: float = 1e-5

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    attn_impl: str = "auto"  # auto | dense | flash_lax | flash_pallas

    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        """SSM inner dim."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (the reference's, for reports) ----
    def param_counts(self) -> dict:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hq = self.num_heads * self.resolved_head_dim
        hkv = self.num_kv_heads * self.resolved_head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if self.qkv_bias:
            attn += hq + 2 * hkv
        if self.ffn_activation == "swiglu":
            ffn_dense = 3 * d * ff
        else:
            ffn_dense = 2 * d * ff + ff + d  # gelu MLP w/ biases
        counts = {"embed": v * d}
        n_experts = max(self.num_experts, 1)
        per_layer = 0.0
        active_per_layer = 0.0
        if self.family == "ssm":
            per_layer = self._ssm_params()
            active_per_layer = per_layer
        else:
            per_layer += attn if self.attention != "none" else 0
            if self.num_experts:
                per_layer += n_experts * ffn_dense + d * n_experts  # router
                active_per_layer += attn + self.num_experts_per_tok * ffn_dense
            else:
                per_layer += ffn_dense
                active_per_layer = per_layer
            if self.hybrid:
                per_layer += self._ssm_params()
                active_per_layer += self._ssm_params()
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            counts["cross_attn"] = n_cross * (2 * d * hq + 2 * d * hkv)
        counts["layers"] = self.num_layers * per_layer
        counts["layers_active"] = self.num_layers * active_per_layer
        if self.encoder_decoder:
            enc = self.num_encoder_layers * (attn + ffn_dense)
            dec_cross = self.num_layers * (2 * d * hq + 2 * d * hkv)
            counts["encoder"] = enc
            counts["cross_attn"] = dec_cross
        return counts

    def num_params(self, active_only: bool = False) -> int:
        c = self.param_counts()
        layers = c["layers_active"] if active_only else c["layers"]
        extra = sum(v for k, v in c.items()
                    if k not in ("layers", "layers_active"))
        return int(layers + extra)

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        # in_proj -> [z, x, B, C, dt] ; conv on (x,B,C); out_proj
        return (d * (2 * di + 2 * n + h)
                + self.ssm_conv * (di + 2 * n)
                + 2 * h  # A_log, D
                + di * d)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch and regime."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode
    microbatches: int = 1  # gradient-accumulation steps (train only)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

LM_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)


@dataclass(frozen=True)
class MeshConfig:
    """A mesh's shape and axis names, and the sharding profile's knobs
    (``distributed.sharding.logical_to_pspec``): ``fsdp`` shards params,
    grads and the optimizer state over the data axes too (ZeRO-3);
    ``seq_shard_kv`` shards a decode cache's sequence over ``"model"``;
    ``profile`` is ``"tp_fsdp"`` (tensor parallelism over ``"model"``
    plus FSDP) or ``"pure_fsdp"`` (no tensor parallelism: small models).
    ``donate`` is kept for parity with the reference, where it donates
    the train state's buffers to the jitted step; the port's step builds
    new tensors and has nothing to donate, so it reads no field of it."""
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")
    fsdp: bool = True
    seq_shard_kv: bool = True
    donate: bool = True
    profile: str = "tp_fsdp"     # tp_fsdp | pure_fsdp

    @property
    def data_axes(self) -> Tuple[str, ...]:
        if self.profile == "pure_fsdp":
            return tuple(self.axes)  # the batch spans the whole mesh
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.03
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1
    # distillation (Eq. 5)
    distill_task: float = 1.0     # lambda_1
    distill_logit: float = 0.0    # lambda_2
    distill_token: float = 0.0    # lambda_3
    # distributed-optimization tricks
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
