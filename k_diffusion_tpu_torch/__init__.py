"""PyTorch/CUDA port of k-diffusion-tpu (the JAX package beside it is the
reference it is held against).

The port covers every model family of the JAX package: the HDiT
(``image_transformer_v2``: neighborhood, global, shifted-window and
attention-free levels), the ViT (``image_transformer_v1``) and the U-Net
(``image_v1``, with cross-attention and a variance head):
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
- training, through its entry point: ``python -m
  k_diffusion_tpu_torch.train --config config.json`` (on the card;
  ``--device cpu`` trains on the CPU), with ``convert_for_inference``,
  ``config_from_inference`` and ``make_grid`` beside it. In code:
  ``data.make_dataset`` -> ``data.DataLoader`` ->
  ``augmentation.KarrasAugmentationPipeline`` on the device ->
  ``training.make_optimizer`` -> ``training.init_train_state`` ->
  ``training.make_train_step`` with ``config.make_sample_density``,
  ``make_lr_schedule`` and ``make_ema_sched``; ``checkpoint.save_checkpoint``
  and ``load_checkpoint`` save and resume it; the trainer scores FID and
  KID (``evaluation``, ``models.inception_v3``) where the Inception
  weights are in the local cache;
- data parallel (``parallel``): under ``python -m torch.distributed.run
  --nproc_per_node N -m k_diffusion_tpu_torch.train ...`` each process is
  one rank; the train step draws at the global batch, takes its rows and
  all-reduces its gradients; ``checkpoint.save_checkpoint_sharded``
  writes ``torch.distributed.checkpoint`` directories in the background;
- the engine: classifier-free and gradient guidance (``guidance``),
  wrappers for other models' schedules (``external``), and the exact
  log-likelihood of the probability-flow ODE (``log_likelihood``, ``ode``).
Models, schedules and densities go to the card unless the caller names a
device. The HDiT's attention prologue, neighborhood and global attention,
feed-forward block and mapping network (also the ViT's), the backwards of
the first four, and the flash attention of the U-Net and the ViT (and of
HDiT global levels that the packed kernel does not take) with its
backward are hand-written CUDA kernels (``ops.kernels``) for CUDA tensors, with plain PyTorch versions for
CPU tensors. Importing the package imports torch and numpy only and
compiles nothing.
"""

from . import (augmentation, checkpoint, condcache, config, convert, data,
               denoiser, evaluation, external, gns, guidance, layers, models,
               ode, ops, optim8bit, parallel, sampling, training, utils)
from .denoiser import Denoiser
from .ode import log_likelihood

__all__ = ["augmentation", "checkpoint", "condcache", "config", "convert",
           "data", "denoiser", "evaluation", "external", "gns", "guidance",
           "layers", "models", "ode", "ops", "optim8bit", "parallel",
           "sampling", "training", "utils", "Denoiser", "log_likelihood"]
