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

import os

from . import flash, fused_ffn, fused_mapping, fused_qkv, global_packed, na2d
from ._build import build


def train_fusion_enabled():
    """Whether training runs the fused attention prologue (K1) and the fused
    feed-forward block (K4), read at each call from ``KDT_TRAIN_FUSION``
    (default "1"), as the JAX package reads it: "0" runs the unfused
    prologue written out in the model and the unfused feed-forward chain in
    training, so that the neighborhood levels go to the per-head kernels
    K11/K12. Sampling always runs fused."""
    return os.environ.get("KDT_TRAIN_FUSION", "1") == "1"


# kernel name -> (module, name of its launch counter): forward kernels
# K1-K5, the backward kernels K6-K10, flash attention K13 and its backward
# K14, the per-head NA kernels K11 and K12, the fused-epilogue NA K15, and
# the float32 forms of K13 and K14, of K1-K5, of K6, K9 and K10 and of the
# neighborhood kernels K7, K8, K11, K12 and K15
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
    "na2d_heads": (na2d, "heads_launches"),
    "na2d_heads_bwd": (na2d, "heads_bwd_launches"),
    "na2d_proj": (na2d, "proj_launches"),
    "flash_f32": (flash, "launches_f32"),
    "flash_bwd_f32": (flash, "bwd_launches_f32"),
    "fused_mapping_f32": (fused_mapping, "launches_f32"),
    "fused_qkv_f32": (fused_qkv, "launches_f32"),
    "fused_qkv_bwd_f32": (fused_qkv, "bwd_launches_f32"),
    "fused_ffn_f32": (fused_ffn, "launches_f32"),
    "fused_ffn_bwd_f32": (fused_ffn, "bwd_launches_f32"),
    "global_packed_f32": (global_packed, "launches_f32"),
    "global_packed_bwd_f32": (global_packed, "bwd_launches_f32"),
    "na2d_f32": (na2d, "launches_f32"),
    "na2d_bwd_f32": (na2d, "bwd_launches_f32"),
    "na2d_heads_f32": (na2d, "heads_launches_f32"),
    "na2d_heads_bwd_f32": (na2d, "heads_bwd_launches_f32"),
    "na2d_overlap_add_f32": (na2d, "overlap_launches_f32"),
    "na2d_proj_f32": (na2d, "proj_launches_f32"),
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset_launch_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


__all__ = ["COUNTERS", "build", "launch_counts", "reset_launch_counts",
           "train_fusion_enabled"]
