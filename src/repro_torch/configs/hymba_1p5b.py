"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
    hybrid=True, ssm_state=16, ssm_expand=1, ssm_head_dim=64,
    attention="sliding_window", window_size=1024,
    source="arXiv:2411.13676",
)
