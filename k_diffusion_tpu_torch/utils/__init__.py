"""Utilities (counterpart of k_diffusion_tpu/utils/): array helpers, the
default device and compute dtype, the training-time sigma densities, LR and
EMA schedules, the EMA update, safetensors files (``io``) and PNG images
(``image``)."""

from .array import append_dims
from .device import compute_dtype, default_device
from .ema import ema_update
from .image import to_png
from .io import get_safetensors_metadata
from .random import (cosine_interpolated, log_logistic, log_normal,
                     log_uniform, rand_cosine_interpolated, rand_log_logistic,
                     rand_log_normal, rand_log_uniform, rand_split_log_normal,
                     rand_v_diffusion, split_log_normal, stratified_uniform,
                     stratify, uniform_maybe_stratified, v_diffusion)
from .schedules import (EMAWarmup, constant_lr_with_warmup, exponential_lr,
                        inverse_lr)

__all__ = [
    "append_dims", "compute_dtype", "default_device", "ema_update",
    "get_safetensors_metadata", "to_png",
    "cosine_interpolated", "log_logistic", "log_normal", "log_uniform",
    "rand_cosine_interpolated", "rand_log_logistic", "rand_log_normal", "rand_log_uniform",
    "rand_split_log_normal", "rand_v_diffusion", "split_log_normal",
    "stratified_uniform", "stratify", "uniform_maybe_stratified",
    "v_diffusion", "EMAWarmup", "constant_lr_with_warmup", "exponential_lr",
    "inverse_lr",
]
