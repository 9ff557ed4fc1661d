"""PyTorch/CUDA port of k-diffusion-tpu (the JAX package beside it is the
reference it is held against).

The port covers the HDiT (``image_transformer_v2``) with neighborhood and
global attention levels:
- sampling with DPM++(2M): ``config.load_config`` -> ``config.make_model``
  -> ``Denoiser`` -> ``sampling.get_sigmas_karras`` ->
  ``sampling.sample_dpmpp_2m``;
- training: ``training.make_optimizer`` -> ``training.init_train_state`` ->
  ``training.make_train_step`` with ``config.make_sample_density``,
  ``make_lr_schedule`` and ``make_ema_sched``.
The attention prologue, neighborhood and global attention, the
feed-forward block and the mapping network, and the backwards of the first
four, are hand-written CUDA kernels (``ops.kernels``) for CUDA tensors,
with plain PyTorch versions for CPU tensors. Importing the package imports
torch only and compiles nothing.
"""

from . import (config, convert, denoiser, layers, models, ops, sampling,
               training, utils)
from .denoiser import Denoiser

__all__ = ["config", "convert", "denoiser", "layers", "models", "ops",
           "sampling", "training", "utils", "Denoiser"]
