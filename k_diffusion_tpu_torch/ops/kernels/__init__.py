"""Hand-written Hopper kernels (counterparts of k_diffusion_tpu/ops/pallas/).

Each module holds a wrapper, the plain PyTorch version of its function and
a count of each of its kernels' launches. A wrapper runs the plain version
for a CPU tensor, and autograd differentiates it; for a CUDA tensor it
launches its kernel, through an autograd Function whose backward launches
the backward kernel (directly when autograd is off, as in sampling), or
raises. The CUDA sources are in
``k_diffusion_tpu_torch/csrc/`` and are compiled at first use (``_build``);
importing this package compiles nothing.
"""

from . import flash, fused_ffn, fused_mapping, fused_qkv, global_packed, na2d
from ._build import build

# kernel name -> (module, name of its launch counter): forward kernels
# K1-K5, the backward kernels K6-K10, then flash attention K13 and its
# backward K14
COUNTERS = {
    "fused_qkv": (fused_qkv, "launches"),
    "na2d": (na2d, "launches"),
    "global_packed": (global_packed, "launches"),
    "fused_ffn": (fused_ffn, "launches"),
    "fused_mapping": (fused_mapping, "launches"),
    "fused_qkv_bwd": (fused_qkv, "bwd_launches"),
    "na2d_bwd": (na2d, "bwd_launches"),
    "na2d_overlap_add": (na2d, "overlap_launches"),
    "global_packed_bwd": (global_packed, "bwd_launches"),
    "fused_ffn_bwd": (fused_ffn, "bwd_launches"),
    "flash": (flash, "launches"),
    "flash_bwd": (flash, "bwd_launches"),
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset_launch_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


__all__ = ["COUNTERS", "build", "launch_counts", "reset_launch_counts"]
