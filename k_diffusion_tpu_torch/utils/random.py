"""Training-time sigma sample densities with explicit stratification
(counterpart of k_diffusion_tpu/utils/random.py).

Each density is split in two: a draw of ``u`` ~ U(0, 1) from the caller's
``torch.Generator`` (``uniform_maybe_stratified``) and a pure transform of
``u`` (``log_normal``, ``cosine_interpolated``, ...). ``rand_*`` composes
the two. The JAX package draws ``u`` from a threefry key, which torch cannot
reproduce; handing the same ``u`` to a transform gives the JAX density's
sigmas. Float32 throughout, as the JAX package.
"""

import math

import torch


def stratify(u, group=0, groups=1):
    """Moves U(0, 1) samples ``u`` (last dim n) into strata ``group,
    group + groups, ...`` of ``n * groups`` equal bins."""
    if groups <= 0:
        raise ValueError(f"groups must be positive, got {groups}")
    n = u.shape[-1] * groups
    offsets = torch.arange(group, n, groups, dtype=u.dtype, device=u.device)
    return (offsets + u) / n


def stratified_uniform(shape, group=0, groups=1, generator=None, device=None):
    """Stratified U(0, 1) samples (see ``stratify``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return stratify(u, group, groups)


def uniform_maybe_stratified(shape, stratified=None, generator=None,
                             device=None):
    """U(0, 1), stratified when ``stratified=(group, groups)`` is given."""
    u = torch.rand(shape, generator=generator, device=device)
    return u if stratified is None else stratify(u, *stratified)


def log_normal(u, loc=0.0, scale=1.0):
    """Lognormal sigmas from U(0, 1) samples."""
    u = u * (1 - 2e-7) + 1e-7
    return torch.exp(torch.special.ndtri(u) * scale + loc)


def log_logistic(u, loc=0.0, scale=1.0, min_value=0.0,
                 max_value=float("inf")):
    """Optionally truncated log-logistic sigmas from U(0, 1) samples. The
    truncation bounds are float32, as the JAX package's: the logit near 1
    magnifies their rounding."""
    def cdf(value):
        return torch.sigmoid(torch.tensor((math.log(value) - loc) / scale,
                                          device=u.device))

    min_cdf = cdf(min_value) if min_value > 0 else 0.0
    max_cdf = cdf(max_value) if max_value != float("inf") else 1.0
    u = u * (max_cdf - min_cdf) + min_cdf
    return torch.exp(torch.logit(u) * scale + loc)


def log_uniform(u, min_value, max_value):
    """Log-uniform sigmas from U(0, 1) samples."""
    lo, hi = math.log(min_value), math.log(max_value)
    return torch.exp(u * (hi - lo) + lo)


def v_diffusion(u, sigma_data=1.0, min_value=0.0, max_value=float("inf")):
    """Truncated v-diffusion (arctan-uniform) sigmas from U(0, 1) samples."""
    min_cdf = math.atan(min_value / sigma_data) * 2 / math.pi
    max_cdf = (math.atan(max_value / sigma_data) * 2 / math.pi
               if max_value != float("inf") else 1.0)
    u = u * (max_cdf - min_cdf) + min_cdf
    return torch.tan(u * math.pi / 2) * sigma_data


def cosine_interpolated(u, image_d, noise_d_low, noise_d_high, sigma_data=1.0,
                        min_value=1e-3, max_value=1e3):
    """Resolution-shifted interpolated cosine logSNR sigmas (simple
    diffusion) from U(0, 1) samples: the density of every shipped config."""

    def logsnr_schedule_cosine(t, logsnr_min, logsnr_max):
        t_min = math.atan(math.exp(-0.5 * logsnr_max))
        t_max = math.atan(math.exp(-0.5 * logsnr_min))
        return -2 * torch.log(torch.tan(t_min + t * (t_max - t_min)))

    def shifted(t, noise_d, logsnr_min, logsnr_max):
        shift = 2 * math.log(noise_d / image_d)
        return logsnr_schedule_cosine(t, logsnr_min - shift,
                                      logsnr_max - shift) + shift

    logsnr_min = -2 * math.log(min_value / sigma_data)
    logsnr_max = -2 * math.log(max_value / sigma_data)
    logsnr_low = shifted(u, noise_d_low, logsnr_min, logsnr_max)
    logsnr_high = shifted(u, noise_d_high, logsnr_min, logsnr_max)
    logsnr = logsnr_low + u * (logsnr_high - logsnr_low)
    return torch.exp(-logsnr / 2) * sigma_data


def split_log_normal(n, u, loc, scale_1, scale_2):
    """Split lognormal sigmas from |N(0, 1)| samples ``n`` and U(0, 1)
    samples ``u``."""
    ratio = scale_1 / (scale_1 + scale_2)
    return torch.exp(torch.where(u < ratio, n * -scale_1 + loc,
                                 n * scale_2 + loc))


def rand_log_normal(shape, loc=0.0, scale=1.0, stratified=None,
                    generator=None, device=None):
    u = uniform_maybe_stratified(shape, stratified, generator, device)
    return log_normal(u, loc, scale)


def rand_log_logistic(shape, loc=0.0, scale=1.0, min_value=0.0,
                      max_value=float("inf"), stratified=None, generator=None,
                      device=None):
    u = uniform_maybe_stratified(shape, stratified, generator, device)
    return log_logistic(u, loc, scale, min_value, max_value)


def rand_log_uniform(shape, min_value, max_value, stratified=None,
                     generator=None, device=None):
    u = uniform_maybe_stratified(shape, stratified, generator, device)
    return log_uniform(u, min_value, max_value)


def rand_v_diffusion(shape, sigma_data=1.0, min_value=0.0,
                     max_value=float("inf"), stratified=None, generator=None,
                     device=None):
    u = uniform_maybe_stratified(shape, stratified, generator, device)
    return v_diffusion(u, sigma_data, min_value, max_value)


def rand_cosine_interpolated(shape, image_d, noise_d_low, noise_d_high,
                             sigma_data=1.0, min_value=1e-3, max_value=1e3,
                             stratified=None, generator=None, device=None):
    u = uniform_maybe_stratified(shape, stratified, generator, device)
    return cosine_interpolated(u, image_d, noise_d_low, noise_d_high,
                               sigma_data, min_value, max_value)


def rand_split_log_normal(shape, loc, scale_1, scale_2, generator=None,
                          device=None):
    """Not stratified, as in the JAX package and the reference."""
    n = torch.randn(shape, generator=generator, device=device).abs()
    u = torch.rand(shape, generator=generator, device=device)
    return split_log_normal(n, u, loc, scale_1, scale_2)
