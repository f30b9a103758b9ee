"""Model configurations of the PyTorch port."""
from __future__ import annotations

from .base import ModelConfig
from .gpt2 import GPT2_SMALL
from .mamba2_2p7b import MAMBA2_2P7B

__all__ = ["ModelConfig", "GPT2_SMALL", "MAMBA2_2P7B"]
