"""EDM preconditioning, loss weightings and loss wrappers (counterpart of
k_diffusion_tpu/denoiser.py). Each wrapper holds a plain callable
``inner_model(x, sigma, **kwargs)``: ``Denoiser`` (with the DCT multiscale
loss weighting for ``scales > 1``), ``DenoiserWithVariance`` (a model with
a variance head) and ``SimpleLossDenoiser``."""

import torch

from . import sampling
from .utils import append_dims, dct, freq_weight_nd


def edm_scalings(sigma, sigma_data=1.0):
    """c_skip, c_out, c_in from Karras et al. 2022."""
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data / (sigma ** 2 + sigma_data ** 2) ** 0.5
    c_in = 1 / (sigma ** 2 + sigma_data ** 2) ** 0.5
    return c_skip, c_out, c_in


def weighting_karras(sigma, sigma_data=1.0):
    return torch.ones_like(sigma)


def weighting_soft_min_snr(sigma, sigma_data=1.0):
    """(sigma * sigma_data)^2 / (sigma^2 + sigma_data^2)^2."""
    return (sigma * sigma_data) ** 2 / (sigma ** 2 + sigma_data ** 2) ** 2


def weighting_snr(sigma, sigma_data=1.0):
    return sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)


_WEIGHTINGS = {
    "karras": weighting_karras,
    "soft-min-snr": weighting_soft_min_snr,
    "snr": weighting_snr,
}


class Denoiser:
    """Karras et al. preconditioner around a plain callable
    ``inner_model(x, sigma, **kwargs)``:
    ``D(x, sigma) = inner(x * c_in, sigma) * c_out + x * c_skip``;
    ``loss`` is the weighted MSE in the preconditioned target space; with
    ``scales > 1`` the squared error is taken in the DCT basis over the
    spatial axes and weighted per frequency (``utils.freq_weight_nd``)."""

    def __init__(self, inner_model, sigma_data=1.0, weighting="karras",
                 scales=1):
        self.inner_model = inner_model
        self.sigma_data = sigma_data
        self.scales = scales
        if callable(weighting):
            self.weighting = weighting
        else:
            try:
                w = _WEIGHTINGS[weighting]
            except KeyError:
                raise ValueError(f"Unknown weighting type {weighting}")
            self.weighting = lambda sigma: w(sigma, self.sigma_data)

    def get_scalings(self, sigma):
        return edm_scalings(sigma, self.sigma_data)

    def loss(self, input, noise, sigma, **kwargs):
        """Per-sample losses (batch,)."""
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        c_weight = self.weighting(sigma)
        noised_input = input + noise * append_dims(sigma, input.ndim)
        model_output = self.inner_model(noised_input * c_in, sigma, **kwargs)
        target = (input - c_skip * noised_input) / c_out
        if self.scales == 1:
            return ((model_output - target) ** 2).reshape(
                input.shape[0], -1).mean(dim=1) * c_weight
        sq_error = dct(model_output - target, range(1, input.ndim - 1)) ** 2
        f_weight = freq_weight_nd(sq_error.shape[1:-1], self.scales,
                                  dtype=sq_error.dtype, device=sq_error.device)
        return (sq_error * f_weight[..., None]).reshape(
            input.shape[0], -1).mean(dim=1) * c_weight

    def __call__(self, input, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        return (self.inner_model(input * c_in, sigma, **kwargs) * c_out
                + input * c_skip)


class DenoiserWithVariance(Denoiser):
    """The NLL loss with the model's predicted per-sample log variance: the
    inner model takes ``return_variance=True`` and returns ``(output,
    logvar)``."""

    def loss(self, input, noise, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        noised_input = input + noise * append_dims(sigma, input.ndim)
        model_output, logvar = self.inner_model(
            noised_input * c_in, sigma, return_variance=True, **kwargs)
        logvar = append_dims(logvar, model_output.ndim)
        target = (input - c_skip * noised_input) / c_out
        losses = ((model_output - target) ** 2 / logvar.exp() + logvar) / 2
        return losses.reshape(input.shape[0], -1).mean(dim=1)


class SimpleLossDenoiser(Denoiser):
    """L_simple (eps-space MSE) on top of the preconditioner."""

    def loss(self, input, noise, sigma, **kwargs):
        noised_input = input + noise * append_dims(sigma, input.ndim)
        denoised = self(noised_input, sigma, **kwargs)
        eps = sampling.to_d(noised_input, sigma, denoised)
        return ((eps - noise) ** 2).reshape(input.shape[0], -1).mean(dim=1)
