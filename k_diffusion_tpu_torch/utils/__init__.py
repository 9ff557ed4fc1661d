"""Utilities (counterpart of k_diffusion_tpu/utils/): array helpers (with
the DCT and the frequency weights of the multiscale loss), the
default device and compute dtype, the training-time sigma densities, LR and
EMA schedules, the EMA update, safetensors files (``io``), PNG images and
grids (``image``), progressive growing (``transfer_params``) and the
metrics CSV (``logging``)."""

from .array import (append_dims, dct, freq_weight_1d, freq_weight_nd,
                    idct, transfer_params)
from .device import compute_dtype, default_device
from .ema import ema_update, ema_update_dict
from .image import from_png, make_grid, to_png
from .io import get_safetensors_metadata
from .logging import CSVLogger
from .random import (cosine_interpolated, log_logistic, log_normal,
                     log_uniform, rand_cosine_interpolated, rand_log_logistic,
                     rand_log_normal, rand_log_uniform, rand_split_log_normal,
                     rand_v_diffusion, split_log_normal, stratified_uniform,
                     stratify, uniform_maybe_stratified, v_diffusion)
from .schedules import (EMAWarmup, constant_lr_with_warmup, exponential_lr,
                        inverse_lr)

__all__ = [
    "append_dims", "dct", "freq_weight_1d", "freq_weight_nd", "idct",
    "transfer_params", "CSVLogger",
    "compute_dtype", "default_device", "ema_update",
    "ema_update_dict",
    "from_png", "get_safetensors_metadata", "make_grid", "to_png",
    "cosine_interpolated", "log_logistic", "log_normal", "log_uniform",
    "rand_cosine_interpolated", "rand_log_logistic", "rand_log_normal", "rand_log_uniform",
    "rand_split_log_normal", "rand_v_diffusion", "split_log_normal",
    "stratified_uniform", "stratify", "uniform_maybe_stratified",
    "v_diffusion", "EMAWarmup", "constant_lr_with_warmup", "exponential_lr",
    "inverse_lr",
]
