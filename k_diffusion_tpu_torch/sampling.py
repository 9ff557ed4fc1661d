"""Sigma schedules and the full sampler suite (counterpart of
k_diffusion_tpu/sampling.py, which runs each fixed-step sampler as one
``lax.scan`` and the adaptive solver as a ``lax.while_loop``).

Model contract: ``model(x, sigma, **extra_args) -> denoised`` with ``sigma``
of shape ``[batch]``.

Where PyTorch's idiom replaces JAX's:
- randomness comes from an explicit ``generator`` (a ``torch.Generator`` on
  x's device) where JAX takes ``key``; deterministic samplers take none;
- ``noise_sampler(sigma, sigma_next) -> noise`` where JAX's takes ``(key,
  sigma, sigma_next)``; the sigmas are host floats;
- the step loop is a Python loop. Its step coefficients come from a host
  copy of the schedule, so a fixed-step sampler never waits on the device,
  and a step whose last stage would evaluate the model at sigma 0 takes the
  Euler step in Python (JAX evaluates it and discards it with a select).
  ``sample_dpm_adaptive`` reads one number a step, the error behind the
  accept decision, as the reference does.
"""

import collections
import inspect
import math

import numpy as np
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


def get_sigmas_exponential(n, sigma_min, sigma_max, device=None):
    """Log-linear schedule, float32."""
    sigmas = torch.exp(torch.linspace(
        math.log(sigma_max), math.log(sigma_min), n, dtype=torch.float32,
        device=default_device(device)))
    return append_zero(sigmas)


def get_sigmas_polyexponential(n, sigma_min, sigma_max, rho=1.0,
                               device=None):
    """Polynomial-in-log-sigma schedule, float32."""
    ramp = torch.linspace(1, 0, n, dtype=torch.float32,
                          device=default_device(device)) ** rho
    sigmas = torch.exp(ramp * (math.log(sigma_max) - math.log(sigma_min))
                       + math.log(sigma_min))
    return append_zero(sigmas)


def get_sigmas_vp(n, beta_d=19.9, beta_min=0.1, eps_s=1e-3, device=None):
    """Continuous VP schedule, float32."""
    t = torch.linspace(1, eps_s, n, dtype=torch.float32,
                       device=default_device(device))
    sigmas = torch.sqrt(torch.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1)
    return append_zero(sigmas)


def get_ancestral_step(sigma_from, sigma_to, eta=1.0):
    """Splits a step into deterministic ``sigma_down`` and stochastic
    ``sigma_up`` parts. Takes host floats (Python's, or numpy float32 to
    compute in float32)."""
    if not eta:
        return sigma_to, 0.0 * sigma_to
    var = sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / sigma_from ** 2
    sigma_up = min(sigma_to, eta * max(var, 0.0) ** 0.5)
    sigma_down = (sigma_to ** 2 - sigma_up ** 2) ** 0.5
    return sigma_down, sigma_up


def default_noise_sampler(x, generator):
    """A fresh gaussian of x's shape per call, drawn from ``generator``."""
    if generator is None:
        raise ValueError("this sampler needs a generator (or a noise_sampler)")
    return lambda sigma, sigma_next: torch.randn(
        x.shape, generator=generator, device=x.device, dtype=x.dtype)


_MASK64 = (1 << 64) - 1


def _mix(z):
    """splitmix64's finaliser: a bijection of 64-bit ints."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def fold_in(seed, data):
    """A child seed of ``seed`` for ``data`` (a small int), the
    counterpart of ``jax.random.fold_in`` on a node's path."""
    return _mix((seed ^ _mix((data + 0x9E3779B97F4A7C15) & _MASK64))
                & _MASK64)


class VirtualBrownianTree:
    """A Brownian motion W on [t0, t1] queryable at any t, as a pure
    function of (seed, t): dyadic bisection with Brownian-bridge midpoints,
    each node's gaussian drawn from a ``torch.Generator`` seeded with the
    node's own seed (``fold_in`` along the descent path, as the JAX tree
    folds its key). It gives identical values for identical (seed, t)
    whatever the query order or the step count. ``t`` is a host float.
    The three values last used are kept: a query costs ``levels``
    gaussians of the full shape, a step of the SDE samplers asks for at
    most three times, and one of them is where the last step ended."""

    def __init__(self, seed, t0, t1, shape, dtype=torch.float32, device=None,
                 levels=24):
        self.seed = int(seed) & _MASK64
        self.t0, self.t1 = float(t0), float(t1)
        self.shape, self.dtype, self.levels = tuple(shape), dtype, levels
        self.device = default_device(device)
        self.generator = torch.Generator(device=self.device)
        self._recent = collections.OrderedDict()

    def _normal(self, seed):
        self.generator.manual_seed(seed)
        return torch.randn(self.shape, generator=self.generator,
                           device=self.device, dtype=self.dtype)

    def __call__(self, t):
        """W(t); W(t0) = 0, increments have variance |interval|."""
        t = float(t)
        if t in self._recent:
            self._recent.move_to_end(t)
        else:
            self._recent[t] = self._value(t)
            if len(self._recent) > 3:
                self._recent.popitem(last=False)
        return self._recent[t]

    def _value(self, t):
        span = self.t1 - self.t0
        u = min(max((t - self.t0) / span, 0.0), 1.0)
        a, b = 0.0, 1.0
        wa = torch.zeros(self.shape, device=self.device, dtype=self.dtype)
        wb = self._normal(fold_in(self.seed, 1)) * abs(span) ** 0.5
        node = fold_in(self.seed, 0)
        for _ in range(self.levels):
            m = 0.5 * (a + b)
            bridge_std = (0.25 * (b - a) * abs(span)) ** 0.5
            wm = 0.5 * (wa + wb) + self._normal(fold_in(node, 2)) * bridge_std
            go_right = u > m
            if go_right:
                a, wa = m, wm
            else:
                b, wb = m, wm
            node = fold_in(node, int(go_right))
        return wa + (wb - wa) * ((u - a) / (b - a))


class BrownianTreeNoiseSampler:
    """Noise that is a pure function of (sigma, sigma_next), the same
    whatever the step count: the normalised increment of a
    ``VirtualBrownianTree`` seeded with ``seed``."""

    def __init__(self, x, sigma_min, sigma_max, seed, transform=lambda s: s):
        self.transform = transform
        t0, t1 = transform(float(sigma_min)), transform(float(sigma_max))
        self.tree = VirtualBrownianTree(seed, min(t0, t1), max(t0, t1),
                                        x.shape, x.dtype, x.device)

    def __call__(self, sigma, sigma_next):
        t0, t1 = self.transform(float(sigma)), self.transform(float(sigma_next))
        return (self.tree(t1) - self.tree(t0)) / abs(t1 - t0) ** 0.5


def _host(sigmas):
    """The schedule as a list of host floats (one copy, before the loop)."""
    return sigmas.detach().to("cpu", torch.float32).tolist()


def _sigma_in(x, sigma):
    """``sigma`` (a host float) broadcast over x's batch, in x's dtype."""
    return torch.full((x.shape[0],), sigma, dtype=x.dtype, device=x.device)


def _callback(callback, **info):
    if callback is not None:
        callback(info)


def _churn_step(x, sigma, generator, n, s_churn, s_tmin, s_tmax, s_noise):
    """Karras Algorithm 2 churn: inflates sigma to sigma_hat and adds
    matching noise. A no-op when s_churn == 0."""
    if s_churn == 0.0:
        return x, sigma
    if generator is None:
        raise ValueError("s_churn > 0 needs a generator")
    gamma = min(s_churn / n, 2 ** 0.5 - 1) if s_tmin <= sigma <= s_tmax else 0.0
    sigma_hat = sigma * (gamma + 1)
    eps = torch.randn(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) * s_noise
    return x + eps * max(sigma_hat ** 2 - sigma ** 2, 0.0) ** 0.5, sigma_hat


@torch.no_grad()
def sample_euler(model, x, sigmas, extra_args=None, callback=None,
                 generator=None, s_churn=0.0, s_tmin=0.0, s_tmax=float("inf"),
                 s_noise=1.0):
    """Algorithm 2 (Euler steps) from Karras et al. 2022."""
    extra_args = {} if extra_args is None else extra_args
    sig = _host(sigmas)
    n = len(sig) - 1
    for i in range(n):
        x, sigma_hat = _churn_step(x, sig[i], generator, n, s_churn, s_tmin,
                                   s_tmax, s_noise)
        s_hat = _sigma_in(x, sigma_hat)
        denoised = model(x, s_hat, **extra_args)
        _callback(callback, x=x, i=i, sigma=sig[i], sigma_hat=sigma_hat,
                  denoised=denoised)
        x = x + to_d(x, s_hat, denoised) * (sig[i + 1] - sigma_hat)
    return x


@torch.no_grad()
def sample_euler_ancestral(model, x, sigmas, extra_args=None, callback=None,
                           generator=None, eta=1.0, s_noise=1.0,
                           noise_sampler=None):
    """Ancestral sampling with Euler steps."""
    extra_args = {} if extra_args is None else extra_args
    noise_sampler = noise_sampler or default_noise_sampler(x, generator)
    sig = _host(sigmas)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        s_in = _sigma_in(x, sigma)
        denoised = model(x, s_in, **extra_args)
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        _callback(callback, x=x, i=i, sigma=sigma, sigma_hat=sigma,
                  denoised=denoised)
        x = x + to_d(x, s_in, denoised) * (sigma_down - sigma)
        if sigma_next > 0:
            x = x + noise_sampler(sigma, sigma_next) * (s_noise * sigma_up)
    return x


@torch.no_grad()
def sample_heun(model, x, sigmas, extra_args=None, callback=None,
                generator=None, s_churn=0.0, s_tmin=0.0, s_tmax=float("inf"),
                s_noise=1.0):
    """Algorithm 2 (Heun steps) from Karras et al. 2022."""
    extra_args = {} if extra_args is None else extra_args
    sig = _host(sigmas)
    n = len(sig) - 1
    for i in range(n):
        sigma_next = sig[i + 1]
        x, sigma_hat = _churn_step(x, sig[i], generator, n, s_churn, s_tmin,
                                   s_tmax, s_noise)
        s_hat = _sigma_in(x, sigma_hat)
        denoised = model(x, s_hat, **extra_args)
        d = to_d(x, s_hat, denoised)
        _callback(callback, x=x, i=i, sigma=sig[i], sigma_hat=sigma_hat,
                  denoised=denoised)
        dt = sigma_next - sigma_hat
        x_euler = x + d * dt
        if sigma_next == 0:
            x = x_euler
            continue
        s_next = _sigma_in(x, sigma_next)
        d_2 = to_d(x_euler, s_next, model(x_euler, s_next, **extra_args))
        x = x + (d + d_2) / 2 * dt
    return x


@torch.no_grad()
def sample_dpm_2(model, x, sigmas, extra_args=None, callback=None,
                 generator=None, s_churn=0.0, s_tmin=0.0, s_tmax=float("inf"),
                 s_noise=1.0):
    """DPM-Solver-2 with Karras churn."""
    extra_args = {} if extra_args is None else extra_args
    sig = _host(sigmas)
    n = len(sig) - 1
    for i in range(n):
        sigma_next = sig[i + 1]
        x, sigma_hat = _churn_step(x, sig[i], generator, n, s_churn, s_tmin,
                                   s_tmax, s_noise)
        s_hat = _sigma_in(x, sigma_hat)
        denoised = model(x, s_hat, **extra_args)
        d = to_d(x, s_hat, denoised)
        _callback(callback, x=x, i=i, sigma=sig[i], sigma_hat=sigma_hat,
                  denoised=denoised)
        if sigma_next == 0:
            x = x + d * (sigma_next - sigma_hat)
            continue
        log_hat = math.log(sigma_hat)
        sigma_mid = math.exp(log_hat + 0.5 * (math.log(sigma_next) - log_hat))
        x_2 = x + d * (sigma_mid - sigma_hat)
        s_mid = _sigma_in(x, sigma_mid)
        d_2 = to_d(x_2, s_mid, model(x_2, s_mid, **extra_args))
        x = x + d_2 * (sigma_next - sigma_hat)
    return x


@torch.no_grad()
def sample_dpm_2_ancestral(model, x, sigmas, extra_args=None, callback=None,
                           generator=None, eta=1.0, s_noise=1.0,
                           noise_sampler=None):
    """Ancestral sampling with DPM-Solver-2 steps."""
    extra_args = {} if extra_args is None else extra_args
    noise_sampler = noise_sampler or default_noise_sampler(x, generator)
    sig = _host(sigmas)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        s_in = _sigma_in(x, sigma)
        denoised = model(x, s_in, **extra_args)
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        _callback(callback, x=x, i=i, sigma=sigma, sigma_hat=sigma,
                  denoised=denoised)
        d = to_d(x, s_in, denoised)
        if sigma_down == 0:
            x = x + d * (sigma_down - sigma)
            continue
        log_s = math.log(sigma)
        sigma_mid = math.exp(log_s + 0.5 * (math.log(sigma_down) - log_s))
        x_2 = x + d * (sigma_mid - sigma)
        s_mid = _sigma_in(x, sigma_mid)
        d_2 = to_d(x_2, s_mid, model(x_2, s_mid, **extra_args))
        x = (x + d_2 * (sigma_down - sigma)
             + noise_sampler(sigma, sigma_next) * (s_noise * sigma_up))
    return x


def linear_multistep_coeff(order, t, i, j):
    """Integral of the Lagrange basis polynomial over [t[i], t[i+1]],
    exact with Gauss-Legendre (the integrand is a polynomial of degree
    below ``order``; the reference integrates it with scipy's quad)."""
    if order - 1 > i:
        raise ValueError(f"Order {order} too high for step {i}")

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod = prod * (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    nodes, weights = np.polynomial.legendre.leggauss(max(1, (order + 1) // 2 + 1))
    a, b = t[i], t[i + 1]
    tau = 0.5 * (b - a) * nodes + 0.5 * (b + a)
    return float(0.5 * (b - a) * np.sum(weights * fn(tau)))


@torch.no_grad()
def sample_lms(model, x, sigmas, extra_args=None, callback=None, order=4):
    """Linear multistep sampler; its integration coefficients are computed
    on the host in float64 before the loop."""
    extra_args = {} if extra_args is None else extra_args
    sig = np.asarray(_host(sigmas), dtype=np.float64)
    ds = []
    for i in range(len(sig) - 1):
        s_in = _sigma_in(x, float(sig[i]))
        denoised = model(x, s_in, **extra_args)
        ds.insert(0, to_d(x, s_in, denoised))
        del ds[order:]
        _callback(callback, x=x, i=i, sigma=float(sig[i]),
                  sigma_hat=float(sig[i]), denoised=denoised)
        cur_order = min(i + 1, order)
        x = x + sum(float(np.float32(linear_multistep_coeff(
            cur_order, sig, i, j))) * ds[j] for j in range(cur_order))
    return x


# DPM-Solver (Lu et al. 2022), t = -log(sigma). The fast and adaptive
# drivers keep t, h and the controller in float32 on the host, as JAX keeps
# them in its float32 carry, so that the adaptive solver takes JAX's
# accept/reject path.

_f32 = np.float32


def _t_dpm(sigma):
    return -np.log(_f32(sigma))


def _sigma_dpm(t):
    return np.exp(-_f32(t))


def _dpm_eps(model, extra_args, x, t):
    sigma = float(_sigma_dpm(t))
    denoised = model(x, _sigma_in(x, sigma), **extra_args)
    return (x - denoised) / sigma, denoised


def _dpm_solver_1_step(x, t, t_next, eps):
    h = _f32(t_next) - _f32(t)
    return x - float(_sigma_dpm(t_next) * np.expm1(h)) * eps


def _dpm_solver_2_step(model, extra_args, x, t, t_next, eps, r1=1 / 2):
    t, t_next = _f32(t), _f32(t_next)
    h = t_next - t
    s1 = t + _f32(r1) * h
    u1 = x - float(_sigma_dpm(s1) * np.expm1(_f32(r1) * h)) * eps
    eps_r1, _ = _dpm_eps(model, extra_args, u1, s1)
    x_2 = (x - float(_sigma_dpm(t_next) * np.expm1(h)) * eps
           - float(_sigma_dpm(t_next) / _f32(2 * r1) * np.expm1(h))
           * (eps_r1 - eps))
    return x_2, eps_r1


def _dpm_solver_3_step(model, extra_args, x, t, t_next, eps, eps_r1=None,
                       r1=1 / 3, r2=2 / 3):
    t, t_next = _f32(t), _f32(t_next)
    h = t_next - t
    s1 = t + _f32(r1) * h
    s2 = t + _f32(r2) * h
    if eps_r1 is None:
        u1 = x - float(_sigma_dpm(s1) * np.expm1(_f32(r1) * h)) * eps
        eps_r1, _ = _dpm_eps(model, extra_args, u1, s1)
    u2 = (x - float(_sigma_dpm(s2) * np.expm1(_f32(r2) * h)) * eps
          - float(_sigma_dpm(s2) * _f32(r2 / r1)
                  * (np.expm1(_f32(r2) * h) / (_f32(r2) * h) - 1))
          * (eps_r1 - eps))
    eps_r2, _ = _dpm_eps(model, extra_args, u2, s2)
    return (x - float(_sigma_dpm(t_next) * np.expm1(h)) * eps
            - float(_sigma_dpm(t_next) / _f32(r2) * (np.expm1(h) / h - 1))
            * (eps_r2 - eps))


@torch.no_grad()
def sample_dpm_fast(model, x, sigma_min, sigma_max, n, extra_args=None,
                    callback=None, generator=None, eta=0.0, s_noise=1.0,
                    noise_sampler=None):
    """DPM-Solver-Fast: ``n`` model evaluations in orders 3, 2 and 1."""
    extra_args = {} if extra_args is None else extra_args
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must not be 0")
    if eta:
        noise_sampler = noise_sampler or default_noise_sampler(x, generator)
    t_end = _f32(-math.log(sigma_min))
    m = math.floor(n / 3) + 1
    ts = np.linspace(-math.log(sigma_max), -math.log(sigma_min), m + 1,
                     dtype=np.float32)
    orders = ([3] * (m - 2) + [2, 1] if n % 3 == 0
              else [3] * (m - 1) + [n % 3])
    for i, order in enumerate(orders):
        t, t_next = ts[i], ts[i + 1]
        if eta:
            sd, su = get_ancestral_step(_sigma_dpm(t), _sigma_dpm(t_next),
                                        eta)
            t_next_ = min(t_end, _t_dpm(sd))
            su = max(float(_sigma_dpm(t_next) ** 2
                           - _sigma_dpm(t_next_) ** 2), 0.0) ** 0.5
        else:
            t_next_, su = t_next, 0.0
        eps, denoised = _dpm_eps(model, extra_args, x, t)
        _callback(callback, x=x, i=i, t=float(ts[i]), t_up=float(t),
                  denoised=denoised, sigma=float(_sigma_dpm(ts[i])),
                  sigma_hat=float(_sigma_dpm(t)))
        if order == 1:
            x = _dpm_solver_1_step(x, t, t_next_, eps)
        elif order == 2:
            x, _ = _dpm_solver_2_step(model, extra_args, x, t, t_next_, eps)
        else:
            x = _dpm_solver_3_step(model, extra_args, x, t, t_next_, eps)
        if eta:
            x = x + (su * s_noise) * noise_sampler(float(_sigma_dpm(t)),
                                                   float(_sigma_dpm(t_next)))
    return x


@torch.no_grad()
def sample_dpm_adaptive(model, x, sigma_min, sigma_max, extra_args=None,
                        callback=None, generator=None, order=3, rtol=0.05,
                        atol=0.0078, h_init=0.05, pcoeff=0.0, icoeff=1.0,
                        dcoeff=0.0, accept_safety=0.81, eta=0.0, s_noise=1.0,
                        noise_sampler=None, return_info=False,
                        max_steps=1000):
    """DPM-Solver-12/23 with adaptive PID step-size control. ``max_steps``
    bounds the loop as it bounds JAX's. Each step reads its error to the
    host for the accept decision; the controller runs there in float32."""
    extra_args = {} if extra_args is None else extra_args
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must not be 0")
    if order not in {2, 3}:
        raise ValueError("order should be 2 or 3")
    if eta:
        noise_sampler = noise_sampler or default_noise_sampler(x, generator)
    t_end = _f32(-math.log(sigma_min))
    t_stop = _f32(-math.log(sigma_min) - 1e-5)
    pid_order = 1.5 if eta else order
    b1 = _f32((pcoeff + icoeff + dcoeff) / pid_order)
    b2 = _f32(-(pcoeff + 2 * dcoeff) / pid_order)
    b3 = _f32(dcoeff / pid_order)
    s, h = _f32(-math.log(sigma_max)), _f32(abs(h_init))
    errs, first = None, True
    info = {"steps": 0, "nfe": 0, "n_accept": 0, "n_reject": 0}
    x_prev = x
    while s < t_stop and info["steps"] < max_steps:
        t = min(t_end, s + h)
        if eta:
            sd, su = get_ancestral_step(_sigma_dpm(s), _sigma_dpm(t), eta)
            t_ = min(t_end, _t_dpm(sd))
            su = max(float(_sigma_dpm(t) ** 2 - _sigma_dpm(t_) ** 2),
                     0.0) ** 0.5
        else:
            t_, su = t, 0.0
        eps, denoised = _dpm_eps(model, extra_args, x, s)
        if order == 2:
            x_low = _dpm_solver_1_step(x, s, t_, eps)
            x_high, _ = _dpm_solver_2_step(model, extra_args, x, s, t_, eps)
        else:
            x_low, eps_r1 = _dpm_solver_2_step(model, extra_args, x, s, t_,
                                               eps, r1=1 / 3)
            x_high = _dpm_solver_3_step(model, extra_args, x, s, t_, eps,
                                        eps_r1=eps_r1)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()),
                            min=atol)
        error = _f32((torch.linalg.vector_norm((x_low - x_high) / delta)
                      / x.numel() ** 0.5).item())
        inv_error = _f32(1) / (error + _f32(1e-8))
        e1, e2 = (inv_error, inv_error) if first else errs
        factor = inv_error ** b1 * e1 ** b2 * e2 ** b3
        factor = _f32(1) + np.arctan(factor - _f32(1))
        accept = bool(factor >= _f32(accept_safety))
        errs = (inv_error, e1) if accept else (e1, e2)
        if accept:
            if eta:
                x_high = x_high + (su * s_noise) * noise_sampler(
                    float(_sigma_dpm(s)), float(_sigma_dpm(t)))
            x, x_prev, s = x_high, x_low, t
        h = h * factor
        first = False
        info["n_accept" if accept else "n_reject"] += 1
        info["nfe"] += order
        info["steps"] += 1
        _callback(callback, x=x, i=info["steps"] - 1, t=float(s),
                  t_up=float(s), denoised=denoised, error=float(error),
                  h=float(h), sigma=float(_sigma_dpm(s)),
                  sigma_hat=float(_sigma_dpm(s)), **info)
    if return_info:
        return x, info
    return x


@torch.no_grad()
def sample_dpmpp_2s_ancestral(model, x, sigmas, extra_args=None,
                              callback=None, generator=None, eta=1.0,
                              s_noise=1.0, noise_sampler=None):
    """Ancestral DPM-Solver++(2S)."""
    extra_args = {} if extra_args is None else extra_args
    noise_sampler = noise_sampler or default_noise_sampler(x, generator)
    sig = _host(sigmas)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        s_in = _sigma_in(x, sigma)
        denoised = model(x, s_in, **extra_args)
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        _callback(callback, x=x, i=i, sigma=sigma, sigma_hat=sigma,
                  denoised=denoised)
        if sigma_down == 0:
            x = x + to_d(x, s_in, denoised) * (sigma_down - sigma)
        else:
            t, t_next = -math.log(sigma), -math.log(sigma_down)
            h = t_next - t
            s = t + h / 2
            x_2 = (math.exp(-s) / math.exp(-t)) * x - math.expm1(-h / 2) * denoised
            denoised_2 = model(x_2, _sigma_in(x, math.exp(-s)), **extra_args)
            x = (math.exp(-t_next) / math.exp(-t)) * x - math.expm1(-h) * denoised_2
        if sigma_next > 0:
            x = x + noise_sampler(sigma, sigma_next) * (s_noise * sigma_up)
    return x


def _brownian_default(x, sigmas, generator, noise_sampler):
    """The SDE samplers' default noise: a Brownian tree over the schedule's
    positive range, seeded from ``generator`` (one draw, read once)."""
    if noise_sampler is not None:
        return noise_sampler
    if generator is None:
        raise ValueError("this sampler needs a generator (or a noise_sampler)")
    sig = _host(sigmas)
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    return BrownianTreeNoiseSampler(x, min(s for s in sig if s > 0), max(sig),
                                    seed)


@torch.no_grad()
def sample_dpmpp_sde(model, x, sigmas, extra_args=None, callback=None,
                     generator=None, eta=1.0, s_noise=1.0, noise_sampler=None,
                     r=1 / 2):
    """DPM-Solver++ (stochastic), 2 stages."""
    extra_args = {} if extra_args is None else extra_args
    noise_sampler = _brownian_default(x, sigmas, generator, noise_sampler)
    sig = _host(sigmas)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        s_in = _sigma_in(x, sigma)
        denoised = model(x, s_in, **extra_args)
        _callback(callback, x=x, i=i, sigma=sigma, sigma_hat=sigma,
                  denoised=denoised)
        if sigma_next == 0:
            x = x + to_d(x, s_in, denoised) * (sigma_next - sigma)
            continue
        t, t_next = -math.log(sigma), -math.log(sigma_next)
        h = t_next - t
        s = t + h * r
        fac = 1 / (2 * r)
        # step 1
        sd, su = get_ancestral_step(math.exp(-t), math.exp(-s), eta)
        s_ = -math.log(sd)
        x_2 = (math.exp(-s_) / math.exp(-t)) * x - math.expm1(t - s_) * denoised
        x_2 = x_2 + noise_sampler(math.exp(-t), math.exp(-s)) * (s_noise * su)
        denoised_2 = model(x_2, _sigma_in(x, math.exp(-s)), **extra_args)
        # step 2
        sd, su = get_ancestral_step(math.exp(-t), math.exp(-t_next), eta)
        t_next_ = -math.log(sd)
        denoised_d = (1 - fac) * denoised + fac * denoised_2
        x = ((math.exp(-t_next_) / math.exp(-t)) * x
             - math.expm1(t - t_next_) * denoised_d
             + noise_sampler(math.exp(-t), math.exp(-t_next)) * (s_noise * su))
    return x


@torch.no_grad()
def sample_dpmpp_2m(model, x, sigmas, extra_args=None, callback=None):
    """DPM-Solver++(2M), deterministic multistep: each step is one model
    call and two fused tensor updates."""
    extra_args = {} if extra_args is None else extra_args
    sig = torch.tensor(_host(sigmas), dtype=torch.float32)
    old_denoised = None
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = model(x, _sigma_in(x, float(sigma)), **extra_args)
        _callback(callback, x=x, i=i, sigma=float(sigma),
                  sigma_hat=float(sigma), denoised=denoised)
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


@torch.no_grad()
def sample_dpmpp_2m_sde(model, x, sigmas, extra_args=None, callback=None,
                        generator=None, eta=1.0, s_noise=1.0,
                        noise_sampler=None, solver_type="midpoint"):
    """DPM-Solver++(2M) SDE, heun and midpoint variants."""
    if solver_type not in {"heun", "midpoint"}:
        raise ValueError("solver_type must be 'heun' or 'midpoint'")
    extra_args = {} if extra_args is None else extra_args
    if eta:
        noise_sampler = _brownian_default(x, sigmas, generator, noise_sampler)
    sig = _host(sigmas)
    old_denoised, h_last = None, None
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = model(x, _sigma_in(x, sigma), **extra_args)
        _callback(callback, x=x, i=i, sigma=sigma, sigma_hat=sigma,
                  denoised=denoised)
        if sigma_next == 0:
            x = denoised
        else:
            h = math.log(sigma) - math.log(sigma_next)
            eta_h = eta * h
            x = ((sigma_next / sigma) * math.exp(-eta_h)) * x \
                + (-math.expm1(-h - eta_h)) * denoised
            if old_denoised is not None:
                r = h_last / h
                if solver_type == "heun":
                    corr = (math.expm1(-h - eta_h) / (h + eta_h) + 1) / r
                else:
                    corr = 0.5 * -math.expm1(-h - eta_h) / r
                x = x + corr * (denoised - old_denoised)
            if eta:
                x = x + noise_sampler(sigma, sigma_next) * (
                    sigma_next * (-math.expm1(-2 * eta_h)) ** 0.5 * s_noise)
            h_last = h
        old_denoised = denoised
    return x


@torch.no_grad()
def sample_dpmpp_3m_sde(model, x, sigmas, extra_args=None, callback=None,
                        generator=None, eta=1.0, s_noise=1.0,
                        noise_sampler=None):
    """DPM-Solver++(3M) SDE."""
    extra_args = {} if extra_args is None else extra_args
    if eta:
        noise_sampler = _brownian_default(x, sigmas, generator, noise_sampler)
    sig = _host(sigmas)
    denoised_1 = denoised_2 = None
    h_1 = h_2 = None
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = model(x, _sigma_in(x, sigma), **extra_args)
        _callback(callback, x=x, i=i, sigma=sigma, sigma_hat=sigma,
                  denoised=denoised)
        if sigma_next == 0:
            x = denoised
        else:
            h = math.log(sigma) - math.log(sigma_next)
            h_eta = h * (eta + 1)
            x = math.exp(-h_eta) * x + (-math.expm1(-h_eta)) * denoised
            phi_2 = math.expm1(-h_eta) / h_eta + 1
            if h_2 is not None:
                phi_3 = phi_2 / h_eta - 0.5
                r0, r1 = h_1 / h, h_2 / h
                d1_0 = (denoised - denoised_1) / r0
                d1_1 = (denoised_1 - denoised_2) / r1
                d1 = d1_0 + (d1_0 - d1_1) * (r0 / (r0 + r1))
                d2 = (d1_0 - d1_1) / (r0 + r1)
                x = x + (phi_2 * d1 - phi_3 * d2)
            elif h_1 is not None:
                x = x + phi_2 * ((denoised - denoised_1) / (h_1 / h))
            if eta:
                x = x + noise_sampler(sigma, sigma_next) * (
                    sigma_next * (-math.expm1(-2 * h * eta)) ** 0.5 * s_noise)
            h_1, h_2 = h, h_1
        denoised_1, denoised_2 = denoised, denoised_1
    return x


def call_sampler(name, model, x, sigmas, extra_args=None, generator=None,
                 **kwargs):
    """Runs the sampler ``sample_{name}`` on the schedule ``sigmas``,
    passing ``generator`` only where the sampler's signature takes one
    (dispatch on the signature, never on a caught TypeError, which would
    hide one raised inside the sampler). The DPM-Solver drivers, which take
    a sigma range rather than a schedule, get the schedule's smallest
    positive and largest sigma and, for ``dpm_fast``, its step count as
    the number of model evaluations."""
    fn = globals().get(f"sample_{name}")
    if fn is None:
        raise ValueError(f"unknown sampler '{name}'")
    params = inspect.signature(fn).parameters
    if "generator" in params and generator is not None:
        kwargs["generator"] = generator
    if "sigmas" in params:
        return fn(model, x, sigmas, extra_args=extra_args, **kwargs)
    sig = _host(sigmas)
    if "n" in params:
        kwargs.setdefault("n", len(sig) - 1)
    return fn(model, x, min(s for s in sig if s > 0), max(sig),
              extra_args=extra_args, **kwargs)


SAMPLERS = ("euler", "euler_ancestral", "heun", "dpm_2", "dpm_2_ancestral",
            "lms", "dpm_fast", "dpm_adaptive", "dpmpp_2s_ancestral",
            "dpmpp_sde", "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_3m_sde")


class DPMSolver:
    """An object interface over the DPM-Solver steps (t = -log(sigma), host
    floats), as the JAX package's ``DPMSolver``."""

    def __init__(self, model, extra_args=None):
        self.model = model
        self.extra_args = {} if extra_args is None else extra_args

    def t(self, sigma):
        return _t_dpm(sigma)

    def sigma(self, t):
        return _sigma_dpm(t)

    def eps(self, x, t):
        return _dpm_eps(self.model, self.extra_args, x, t)[0]

    @torch.no_grad()
    def dpm_solver_1_step(self, x, t, t_next):
        return _dpm_solver_1_step(x, t, t_next, self.eps(x, t))

    @torch.no_grad()
    def dpm_solver_2_step(self, x, t, t_next, r1=1 / 2):
        return _dpm_solver_2_step(self.model, self.extra_args, x, t, t_next,
                                  self.eps(x, t), r1=r1)[0]

    @torch.no_grad()
    def dpm_solver_3_step(self, x, t, t_next, r1=1 / 3, r2=2 / 3):
        return _dpm_solver_3_step(self.model, self.extra_args, x, t, t_next,
                                  self.eps(x, t), r1=r1, r2=r2)

    def dpm_solver_fast(self, x, t_start, t_end, nfe, eta=0.0, s_noise=1.0,
                        noise_sampler=None, generator=None):
        return sample_dpm_fast(
            self.model, x, float(_sigma_dpm(t_end)),
            float(_sigma_dpm(t_start)), nfe, extra_args=self.extra_args,
            eta=eta, s_noise=s_noise, noise_sampler=noise_sampler,
            generator=generator)

    def dpm_solver_adaptive(self, x, t_start, t_end, order=3, rtol=0.05,
                            atol=0.0078, h_init=0.05, pcoeff=0.0, icoeff=1.0,
                            dcoeff=0.0, accept_safety=0.81, eta=0.0,
                            s_noise=1.0, noise_sampler=None, generator=None):
        """Returns (x, info)."""
        return sample_dpm_adaptive(
            self.model, x, float(_sigma_dpm(t_end)),
            float(_sigma_dpm(t_start)), extra_args=self.extra_args,
            order=order, rtol=rtol, atol=atol, h_init=h_init, pcoeff=pcoeff,
            icoeff=icoeff, dcoeff=dcoeff, accept_safety=accept_safety,
            eta=eta, s_noise=s_noise, noise_sampler=noise_sampler,
            generator=generator, return_info=True)
