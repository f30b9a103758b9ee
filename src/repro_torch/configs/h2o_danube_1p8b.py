"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense", num_layers=24, d_model=2560,
    num_heads=32, num_kv_heads=8, d_ff=6912, vocab_size=32000,
    attention="sliding_window", window_size=4096,
    source="arXiv:2401.16818",
)
