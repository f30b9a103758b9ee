from .model import (cross_entropy, generate, loss_fn, sample_token,
                    serve_prefill, serve_step)
from .transformer import (decode_step, forward, init_cache, model_init,
                          model_specs, param_shapes)

__all__ = ["cross_entropy", "decode_step", "forward", "generate",
           "init_cache", "loss_fn", "model_init", "model_specs", "param_shapes",
           "sample_token",
           "serve_prefill", "serve_step"]
