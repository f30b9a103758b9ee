"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

Frontend is a stub, as in the reference: the batches carry precomputed
frame embeddings of shape (batch, 1500, 1280) in place of the conv stem.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    encoder_decoder=True, num_encoder_layers=32,
    frontend="audio_stub", num_frontend_tokens=1500, frontend_dim=1280,
    norm="layernorm", pos_emb="learned", ffn_activation="gelu",
    max_position=65536,
    source="arXiv:2212.04356",
)
