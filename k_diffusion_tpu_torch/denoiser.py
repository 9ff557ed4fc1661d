"""EDM preconditioning and loss weightings (counterpart of
k_diffusion_tpu/denoiser.py). Eval only: the loss wrappers come with the
training port."""

import torch

from .utils import append_dims


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
    ``D(x, sigma) = inner(x * c_in, sigma) * c_out + x * c_skip``."""

    def __init__(self, inner_model, sigma_data=1.0, weighting="karras",
                 scales=1):
        if scales != 1:
            raise NotImplementedError(
                "multiscale loss weighting comes with the training port")
        self.inner_model = inner_model
        self.sigma_data = sigma_data
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

    def __call__(self, input, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        return (self.inner_model(input * c_in, sigma, **kwargs) * c_out
                + input * c_skip)
