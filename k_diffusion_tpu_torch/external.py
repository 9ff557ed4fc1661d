"""Wrappers that expose other diffusion models through the continuous-sigma
denoiser interface, so that every sampler and the log-likelihood run on
them (counterpart of k_diffusion_tpu/external.py). The inner model is any
callable ``(x, t, **kwargs) -> output``; the schedule math is plain torch
on the device of the schedule's tensor."""

import math

import torch

from . import sampling
from .utils import append_dims


class VDenoiser:
    """A v-objective continuous-time model (sigma <-> t by atan / tan) in
    the sigma interface."""

    def __init__(self, inner_model):
        self.inner_model = inner_model
        self.sigma_data = 1.0

    def get_scalings(self, sigma):
        c_skip = self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)
        c_out = -sigma * self.sigma_data / (sigma ** 2 + self.sigma_data ** 2) ** 0.5
        c_in = 1 / (sigma ** 2 + self.sigma_data ** 2) ** 0.5
        return c_skip, c_out, c_in

    def sigma_to_t(self, sigma):
        return torch.atan(sigma) / math.pi * 2

    def t_to_sigma(self, t):
        return torch.tan(t * math.pi / 2)

    def loss(self, input, noise, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        noised_input = input + noise * append_dims(sigma, input.ndim)
        model_output = self.inner_model(noised_input * c_in,
                                        self.sigma_to_t(sigma), **kwargs)
        target = (input - c_skip * noised_input) / c_out
        return ((model_output - target) ** 2).reshape(input.shape[0], -1).mean(1)

    def __call__(self, input, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        return (self.inner_model(input * c_in, self.sigma_to_t(sigma), **kwargs)
                * c_out + input * c_skip)


class DiscreteSchedule:
    """Maps between continuous sigmas and a model's discrete timestep
    indices by interpolating log sigma (``quantize``: the nearest index)."""

    def __init__(self, sigmas, quantize):
        self.sigmas = torch.as_tensor(sigmas)
        self.log_sigmas = torch.log(self.sigmas)
        self.quantize = quantize

    @property
    def sigma_min(self):
        return self.sigmas[0]

    @property
    def sigma_max(self):
        return self.sigmas[-1]

    def get_sigmas(self, n=None):
        """The schedule resampled to n steps, descending, with a final 0."""
        if n is None:
            return sampling.append_zero(self.sigmas.flip(0))
        t_max = len(self.sigmas) - 1
        t = torch.linspace(t_max, 0, n, device=self.sigmas.device)
        return sampling.append_zero(self.t_to_sigma(t))

    def sigma_to_t(self, sigma, quantize=None):
        quantize = self.quantize if quantize is None else quantize
        log_sigma = torch.log(sigma)
        dists = log_sigma - self.log_sigmas[:, None]
        if quantize:
            return dists.abs().argmin(dim=0).reshape(sigma.shape)
        low_idx = (dists >= 0).cumsum(dim=0).argmax(dim=0).clamp(
            0, self.log_sigmas.shape[0] - 2)
        high_idx = low_idx + 1
        low, high = self.log_sigmas[low_idx], self.log_sigmas[high_idx]
        w = ((low - log_sigma) / (low - high)).clamp(0, 1)
        t = (1 - w) * low_idx + w * high_idx
        return t.reshape(sigma.shape)

    def t_to_sigma(self, t):
        t = t.float()
        low_idx, high_idx = t.floor().long(), t.ceil().long()
        w = t - low_idx
        log_sigma = ((1 - w) * self.log_sigmas[low_idx]
                     + w * self.log_sigmas[high_idx])
        return log_sigma.exp()


class DiscreteEpsDDPMDenoiser(DiscreteSchedule):
    """A discrete-schedule DDPM model that predicts eps."""

    def __init__(self, model, alphas_cumprod, quantize):
        super().__init__(((1 - alphas_cumprod) / alphas_cumprod) ** 0.5,
                         quantize)
        self.inner_model = model
        self.sigma_data = 1.0

    def get_scalings(self, sigma):
        c_out = -sigma
        c_in = 1 / (sigma ** 2 + self.sigma_data ** 2) ** 0.5
        return c_out, c_in

    def get_eps(self, *args, **kwargs):
        return self.inner_model(*args, **kwargs)

    def loss(self, input, noise, sigma, **kwargs):
        c_out, c_in = [append_dims(s, input.ndim)
                       for s in self.get_scalings(sigma)]
        noised_input = input + noise * append_dims(sigma, input.ndim)
        eps = self.get_eps(noised_input * c_in, self.sigma_to_t(sigma),
                           **kwargs)
        return ((eps - noise) ** 2).reshape(input.shape[0], -1).mean(1)

    def __call__(self, input, sigma, **kwargs):
        c_out, c_in = [append_dims(s, input.ndim)
                       for s in self.get_scalings(sigma)]
        eps = self.get_eps(input * c_in, self.sigma_to_t(sigma), **kwargs)
        return input + eps * c_out


class OpenAIDenoiser(DiscreteEpsDDPMDenoiser):
    """An OpenAI guided-diffusion model: with ``has_learned_sigmas`` the
    output's channels (last axis, NHWC) are eps and the learned variance,
    and only eps is read."""

    def __init__(self, model, alphas_cumprod, quantize=False,
                 has_learned_sigmas=True):
        super().__init__(model, torch.as_tensor(alphas_cumprod,
                                                dtype=torch.float32),
                         quantize=quantize)
        self.has_learned_sigmas = has_learned_sigmas

    def get_eps(self, *args, **kwargs):
        model_output = self.inner_model(*args, **kwargs)
        if self.has_learned_sigmas:
            return model_output.chunk(2, dim=-1)[0]
        return model_output


class CompVisDenoiser(DiscreteEpsDDPMDenoiser):
    """A CompVis latent-diffusion model that predicts eps (its
    ``apply_model`` as the inner callable)."""

    def __init__(self, model, alphas_cumprod, quantize=False):
        super().__init__(model, alphas_cumprod, quantize=quantize)


class DiscreteVDDPMDenoiser(DiscreteSchedule):
    """A discrete-schedule DDPM model that predicts v."""

    def __init__(self, model, alphas_cumprod, quantize):
        super().__init__(((1 - alphas_cumprod) / alphas_cumprod) ** 0.5,
                         quantize)
        self.inner_model = model
        self.sigma_data = 1.0

    def get_scalings(self, sigma):
        c_skip = self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)
        c_out = -sigma * self.sigma_data / (sigma ** 2 + self.sigma_data ** 2) ** 0.5
        c_in = 1 / (sigma ** 2 + self.sigma_data ** 2) ** 0.5
        return c_skip, c_out, c_in

    def get_v(self, *args, **kwargs):
        return self.inner_model(*args, **kwargs)

    def loss(self, input, noise, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        noised_input = input + noise * append_dims(sigma, input.ndim)
        model_output = self.get_v(noised_input * c_in, self.sigma_to_t(sigma),
                                  **kwargs)
        target = (input - c_skip * noised_input) / c_out
        return ((model_output - target) ** 2).reshape(input.shape[0], -1).mean(1)

    def __call__(self, input, sigma, **kwargs):
        c_skip, c_out, c_in = [append_dims(s, input.ndim)
                               for s in self.get_scalings(sigma)]
        return (self.get_v(input * c_in, self.sigma_to_t(sigma), **kwargs)
                * c_out + input * c_skip)


class CompVisVDenoiser(DiscreteVDDPMDenoiser):
    """A CompVis model that predicts v; ``cond`` is passed positionally."""

    def __init__(self, model, alphas_cumprod, quantize=False):
        super().__init__(model, alphas_cumprod, quantize=quantize)

    def get_v(self, x, t, cond=None, **kwargs):
        return self.inner_model(x, t, cond)
