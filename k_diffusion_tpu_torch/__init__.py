"""PyTorch/CUDA port of k-diffusion-tpu (the JAX package beside it is the
reference it is held against).

The port covers the HDiT (``image_transformer_v2``) with neighborhood and
global attention levels and the U-Net (``image_v1``):
- sampling with DPM++(2M): ``config.load_config`` -> ``config.make_model``
  -> ``config.make_denoiser_wrapper`` -> ``sampling.get_sigmas_karras`` ->
  ``sampling.sample_dpmpp_2m``;
- training: ``training.make_optimizer`` -> ``training.init_train_state`` ->
  ``training.make_train_step`` with ``config.make_sample_density``,
  ``make_lr_schedule`` and ``make_ema_sched``.
Models, schedules and densities go to the card unless the caller names a
device. The HDiT's attention prologue, neighborhood and global attention,
feed-forward block and mapping network, the backwards of the first four,
and the flash attention of the U-Net (and of HDiT global levels that the
packed kernel does not take) with its backward are hand-written CUDA
kernels (``ops.kernels``) for CUDA tensors, with plain PyTorch versions for
CPU tensors. Importing the package imports torch only and compiles
nothing.
"""

from . import (augmentation, config, convert, denoiser, layers, models, ops,
               sampling, training, utils)
from .denoiser import Denoiser

__all__ = ["augmentation", "config", "convert", "denoiser", "layers",
           "models", "ops", "sampling", "training", "utils", "Denoiser"]
