"""BERT-base / BERT-large — the paper's own encoder reproduction targets."""
from .base import ModelConfig

BERT_BASE = ModelConfig(
    name="bert-base", family="encoder", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=30522,
    causal=False, norm="layernorm", pos_emb="learned", ffn_activation="gelu",
    max_position=512, tie_embeddings=False, source="arXiv:1810.04805",
)

BERT_LARGE = BERT_BASE.replace(
    name="bert-large", num_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096)
