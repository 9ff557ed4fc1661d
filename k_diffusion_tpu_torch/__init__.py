"""PyTorch/CUDA port of k-diffusion-tpu (the JAX package beside it is the
reference it is held against).

This slice covers the eval path of the HDiT (``image_transformer_v2``)
sampled with DPM++(2M): ``config.load_config`` -> ``config.make_model`` ->
``Denoiser`` -> ``sampling.get_sigmas_karras`` -> ``sampling.sample_dpmpp_2m``.
The attention prologue, neighborhood and global attention, the
feed-forward block and the mapping network are hand-written CUDA kernels
(``ops.kernels``) for CUDA tensors, with plain PyTorch versions for CPU
tensors. Importing the package imports torch only and compiles nothing.
"""

from . import config, convert, denoiser, layers, models, ops, sampling, utils
from .denoiser import Denoiser

__all__ = ["config", "convert", "denoiser", "layers", "models", "ops",
           "sampling", "utils", "Denoiser"]
