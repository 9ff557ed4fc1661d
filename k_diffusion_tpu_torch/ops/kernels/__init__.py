"""Hand-written Hopper kernels (counterparts of k_diffusion_tpu/ops/pallas/).

Each module holds a wrapper, the plain PyTorch version of its function and
``launches``, the count of its kernel launches. A wrapper runs the plain
version for a CPU tensor; for a CUDA tensor it launches its kernel or
raises. The CUDA sources are in ``k_diffusion_tpu_torch/csrc/`` and are
compiled at first use (``_build``); importing this package compiles nothing.
"""

from . import fused_ffn, fused_mapping, fused_qkv, global_packed, na2d
from ._build import build

MODULES = {"fused_qkv": fused_qkv, "na2d": na2d,
           "global_packed": global_packed, "fused_ffn": fused_ffn,
           "fused_mapping": fused_mapping}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in MODULES.items()}


def reset_launch_counts():
    for mod in MODULES.values():
        mod.launches = 0


__all__ = ["MODULES", "build", "launch_counts", "reset_launch_counts"]
