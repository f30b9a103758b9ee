"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ModelConfig

MAMBA2_2P7B = ModelConfig(
    name="mamba2-2.7b", family="ssm", num_layers=64, d_model=2560,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    attention="none", ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=128,
    pos_emb="none", tie_embeddings=True,
    source="arXiv:2405.21060",
)
