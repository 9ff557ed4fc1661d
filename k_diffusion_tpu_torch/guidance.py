"""Guided-sampling model wrappers (counterpart of
k_diffusion_tpu/guidance.py): combinators over the denoiser contract
``model(x, sigma, **kwargs) -> denoised``."""

import torch

from .utils import append_dims


def spherical_dist_loss(x, y):
    """Squared arc distance between the directions of x and y, along the
    last axis."""
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return torch.arcsin(torch.linalg.vector_norm(x - y, dim=-1) / 2) ** 2 * 2


def make_cond_model_fn(model, cond_fn):
    """denoised + sigma ** 2 * cond_fn(x, sigma, denoised=denoised,
    **kwargs): ``cond_fn`` returns the guidance gradient, which the caller
    computes (with ``torch.autograd.grad``), as the JAX caller's cond_fn
    takes ``jax.grad``."""

    def model_fn(x, sigma, **kwargs):
        denoised = model(x, sigma, **kwargs)
        cond_grad = cond_fn(x, sigma, denoised=denoised, **kwargs)
        return denoised + cond_grad * append_dims(sigma ** 2, x.ndim)

    return model_fn


def make_static_thresh_model_fn(model, value=1.0):
    """Clamps the denoised prediction to [-value, value]."""

    def model_fn(x, sigma, **kwargs):
        return torch.clamp(model(x, sigma, **kwargs), -value, value)

    return model_fn


def make_cfg_model_fn(model, cfg_scale, num_classes):
    """Classifier-free guidance: one call on the batch doubled, the first
    half with ``class_cond`` replaced by the unconditional class
    ``num_classes``; uncond + (cond - uncond) * cfg_scale. At scale 1 the
    model itself."""

    def model_fn(x, sigma, class_cond, **kwargs):
        x_in = torch.cat([x, x])
        sigma_in = torch.cat([sigma, sigma])
        class_in = torch.cat([torch.full_like(class_cond, num_classes),
                              class_cond])
        out = model(x_in, sigma_in, class_cond=class_in, **kwargs)
        out_uncond, out_cond = out.chunk(2)
        return out_uncond + (out_cond - out_uncond) * cfg_scale

    if cfg_scale == 1:
        return model
    return model_fn
