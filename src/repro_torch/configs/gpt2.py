"""GPT2-small — the paper's own decoder reproduction target."""
from .base import ModelConfig

GPT2_SMALL = ModelConfig(
    name="gpt2-small", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=50257,
    norm="layernorm", pos_emb="learned", ffn_activation="gelu",
    max_position=1024, source="GPT-2 (Radford et al. 2019)",
)
