from .synthetic import (calibration_batches, make_batch_np, synthetic_stream,
                        synthetic_tokens)

__all__ = ["calibration_batches", "make_batch_np", "synthetic_stream",
           "synthetic_tokens"]
