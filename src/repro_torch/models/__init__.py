from .model import cross_entropy, loss_fn
from .transformer import forward, model_init

__all__ = ["cross_entropy", "forward", "loss_fn", "model_init"]
