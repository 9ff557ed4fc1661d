"""Sigma schedule and the DPM++(2M) sampler (counterpart of
k_diffusion_tpu/sampling.py). The JAX package runs the sampler as one
``lax.scan``; here it is a Python loop over eager model calls.

Model contract: ``model(x, sigma, **extra_args) -> denoised`` with ``sigma``
of shape ``[batch]``.
"""

import torch

from .utils import append_dims, default_device


def to_d(x, sigma, denoised):
    """Converts a denoiser output to a Karras ODE derivative."""
    return (x - denoised) / append_dims(sigma, x.ndim)


def append_zero(x):
    """Appends the terminal sigma=0 to a schedule."""
    return torch.cat([x, x.new_zeros([1])])


def get_sigmas_karras(n, sigma_min, sigma_max, rho=7.0, device=None):
    """Karras et al. (2022) rho-schedule, float32, on ``device`` (default:
    the card, see ``utils.default_device``)."""
    ramp = torch.linspace(0, 1, n, dtype=torch.float32,
                          device=default_device(device))
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas)


@torch.no_grad()
def sample_dpmpp_2m(model, x, sigmas, extra_args=None, callback=None):
    """DPM-Solver++(2M), deterministic multistep.

    The step coefficients are computed once on the host in float32 (the
    schedule is known before the loop), so the loop never waits on the
    device; each step is one model call and two fused tensor updates."""
    extra_args = {} if extra_args is None else extra_args
    sig = sigmas.detach().to("cpu", torch.float32)
    sigmas = sigmas.to(x.device)
    n = len(sig) - 1
    s_in = x.new_ones([x.shape[0]])
    old_denoised = None
    for i in range(n):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = model(x, sigmas[i] * s_in, **extra_args)
        if callback is not None:
            callback({"x": x, "i": i, "sigma": sigmas[i],
                      "sigma_hat": sigmas[i], "denoised": denoised})
        t, t_next = -torch.log(sigma), -torch.log(sigma_next)
        h = t_next - t
        if old_denoised is None or sigma_next == 0:
            denoised_d = denoised
        else:
            r = (t - (-torch.log(sig[i - 1]))) / h
            denoised_d = (float(1 + 1 / (2 * r)) * denoised
                          - float(1 / (2 * r)) * old_denoised)
        x = float(sigma_next / sigma) * x - float(torch.expm1(-h)) * denoised_d
        old_denoised = denoised
    return x
