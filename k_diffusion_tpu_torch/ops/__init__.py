"""Plain tensor ops (counterpart of k_diffusion_tpu/ops/) and, under
``kernels``, the hand-written CUDA kernels with their plain versions."""

from . import attention, geglu, kernels, norms, rope
from .attention import global_attention, neighborhood_attention
from .geglu import linear_geglu
from .norms import rms_norm, scale_for_cosine_sim
from .rope import (apply_rotary_emb, axial_rope_freqs, axial_rope_theta,
                   downscale_pos, make_axial_pos)

__all__ = ["attention", "geglu", "kernels", "norms", "rope",
           "global_attention", "neighborhood_attention", "linear_geglu",
           "rms_norm", "scale_for_cosine_sim", "apply_rotary_emb",
           "axial_rope_freqs", "axial_rope_theta", "downscale_pos",
           "make_axial_pos"]
