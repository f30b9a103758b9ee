from .adamw import adamw_init, adamw_update, clip_by_global_norm, global_norm
from .schedule import make_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "make_schedule"]
