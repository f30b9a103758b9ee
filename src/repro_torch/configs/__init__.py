"""Model configurations of the PyTorch port."""
from __future__ import annotations

from .base import ModelConfig
from .gpt2 import GPT2_SMALL

__all__ = ["ModelConfig", "GPT2_SMALL"]
