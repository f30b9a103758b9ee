"""llama-3.2-vision-11b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Frontend is a stub, as in the reference: the batches carry precomputed
patch embeddings of shape (batch, 1601, 4096). A cross-attention module
follows every ``cross_attn_every`` self layers (8 over the 40 self
layers), as the reference builds it; the published text model counts
its cross layers among its 40.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    cross_attn_every=5, frontend="vision_stub", num_frontend_tokens=1601,
    frontend_dim=4096, rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
