from .losses import distillation_loss, logit_kl, token_distill

__all__ = ["distillation_loss", "logit_kl", "token_distill"]
