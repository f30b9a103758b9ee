from .adamw import adamw_init, adamw_update, clip_by_global_norm, global_norm
from .compression import int8_ef_compress, int8_ef_init
from .schedule import make_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "int8_ef_compress", "int8_ef_init",
           "make_schedule"]
