"""PyTorch/CUDA port of k-diffusion-tpu (the JAX package beside it is the
reference it is held against).

The port covers the HDiT (``image_transformer_v2``) with neighborhood and
global attention levels and the U-Net (``image_v1``):
- sampling from an inference checkpoint, the serving entry point:
  ``python -m k_diffusion_tpu_torch.sample --checkpoint model.safetensors
  -n 64 --sampler lms`` (on the card; ``--device cpu`` runs the kernels'
  plain versions on the CPU, as the tests do). In code:
  ``checkpoint.load_inference`` -> ``config.make_model`` ->
  ``config.make_denoiser_wrapper`` -> a schedule
  (``sampling.get_sigmas_karras`` and the others) ->
  ``sampling.call_sampler`` (13 samplers), with the HDiT's conditioning
  precomputed for the schedule by ``condcache`` under the samplers that
  evaluate it at schedule sigmas only; ``checkpoint.save_inference``
  writes such a checkpoint (safetensors, read and written by
  ``utils.io``, readable by the JAX package);
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

from . import (augmentation, checkpoint, condcache, config, convert,
               denoiser, layers, models, ops, sampling, training, utils)
from .denoiser import Denoiser

__all__ = ["augmentation", "checkpoint", "condcache", "config", "convert",
           "denoiser", "layers", "models", "ops", "sampling", "training",
           "utils", "Denoiser"]
