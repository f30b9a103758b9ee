"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version and behind a wrapper that counts its launches."""
from .flash_attention import flash_attention, flash_attention_plain
from .hessian_accum import hessian_accum, hessian_accum_plain
from .obs_downdate import obs_downdate, obs_downdate_plain
from .ssd_scan import (ssd_intra_chunk, ssd_intra_chunk_backward,
                       ssd_intra_chunk_backward_plain, ssd_intra_chunk_plain)

KERNELS = (hessian_accum, obs_downdate, flash_attention, ssd_intra_chunk,
           ssd_intra_chunk_backward)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "flash_attention", "flash_attention_plain",
           "hessian_accum", "hessian_accum_plain", "obs_downdate",
           "obs_downdate_plain", "reset_launch_counts", "ssd_intra_chunk",
           "ssd_intra_chunk_backward", "ssd_intra_chunk_backward_plain",
           "ssd_intra_chunk_plain"]
