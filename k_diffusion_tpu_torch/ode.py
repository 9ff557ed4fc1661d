"""Adaptive Dormand-Prince (dopri5) integration and the exact
log-likelihood of the probability-flow ODE with a Hutchinson trace
estimate (counterpart of k_diffusion_tpu/ode.py).

The integrator is a Python loop over tensors on the state's device, with
the JAX package's tableau, error norm and step control, its step size and
time kept in float32 on the host as JAX keeps them on the device; each step
reads its error ratio back to decide.

The divergence term is v . (dd/dx) v for a Rademacher probe v. The JAX
package takes a forward-mode ``jax.jvp`` and so routes its model to the
XLA paths (custom_vjp Pallas kernels have no jvp rule). Here it is the
reverse-mode estimate v . grad((d * v).sum(), x), which is v^T J^T v =
v^T J v: every kernel wrapper is an autograd Function with a backward
kernel, so the model runs on its kernels, forward and backward, with no
plain-version mode.
"""

import math

import numpy as np
import torch

from .sampling import to_d

_F32 = np.float32
# Dormand-Prince 5(4) Butcher tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B_HIGH = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B_LOW = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)
_B_ERR = tuple(bh - bl for bh, bl in zip(_B_HIGH, _B_LOW))


def _lincomb(h, coeffs, ks, base):
    """base + sum_i (h * c_i) * k_i over tuples of tensors, h * c_i in
    float32, zero coefficients skipped, in the JAX package's order."""
    out = base
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            a = float(h * _F32(c))
            out = tuple(o + a * ki for o, ki in zip(out, k))
    return out


def _error_ratio(err, y0, y1, rtol, atol):
    """The RMS over every element of err / (atol + rtol * max(|y0|, |y1|)),
    read back as float32."""
    total, count = 0.0, 0
    for e, a, b in zip(err, y0, y1):
        scale = atol + rtol * torch.maximum(a.abs(), b.abs())
        total = total + ((e / scale) ** 2).sum()
        count += e.numel()
    return _F32(torch.sqrt(total / count).item())


def odeint_dopri5(f, y0, t0, t1, rtol=1e-4, atol=1e-4, max_steps=2000,
                  h_init=None):
    """Integrates dy/dt = f(t, y) from t0 to t1 (t1 > t0); y a tensor or a
    tuple of tensors, ``f(t, y)`` with t a float. Returns (y1, info), info
    {"steps", "nfe", "naccept"}. Step control: safety 0.9, exponent 1/5,
    the factor clipped to [0.2, 10], first step (t1 - t0) / 100."""
    single = torch.is_tensor(y0)
    y = (y0,) if single else tuple(y0)

    def call(t, y):
        out = f(float(t), y[0] if single else y)
        return (out,) if single else tuple(out)

    t0, t1 = _F32(t0), _F32(t1)
    h = (t1 - t0) * _F32(0.01) if h_init is None else _F32(h_init)
    t, fy = t0, call(t0, y)
    steps, nfe, naccept = 0, 1, 0
    while t < t1 - _F32(1e-8) and steps < max_steps:
        h = min(h, t1 - t)
        ks = [fy]
        for i in range(1, 7):
            ks.append(call(t + _F32(_C[i]) * h, _lincomb(h, _A[i], ks, y)))
        y_high = _lincomb(h, _B_HIGH, ks, y)
        err = _lincomb(h, _B_ERR, ks, tuple(torch.zeros_like(v) for v in y))
        ratio = _error_ratio(err, y, y_high, rtol, atol)
        if ratio <= 1:
            t, y, fy = t + h, y_high, ks[6]  # FSAL: stage 7 is f(t + h)
            naccept += 1
        growth = _F32(10.0) if ratio == 0 else ratio ** _F32(-0.2)
        h = h * np.clip(_F32(0.9) * growth, _F32(0.2), _F32(10.0))
        steps += 1
        nfe += 6
    return (y[0] if single else y), {"steps": steps, "nfe": nfe,
                                     "naccept": naccept}


def flow_and_divergence(model, x, sigma, probe, extra_args=None):
    """The probability-flow derivative d = (x - D(x, sigma)) / sigma and the
    Hutchinson estimate of its divergence for the probe v, per image: v .
    grad((d * v).sum(), x) = v^T J v. Returns (d, d_ll), both detached."""
    extra_args = {} if extra_args is None else extra_args
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        denoised = model(x, x.new_full([x.shape[0]], sigma), **extra_args)
        d = to_d(x, x.new_full([x.shape[0]], sigma), denoised)
        grad, = torch.autograd.grad((d * probe).sum(), x)
    d_ll = (probe * grad).reshape(x.shape[0], -1).sum(1)
    return d.detach(), d_ll


def log_likelihood(model, x, sigma_min, sigma_max, extra_args=None,
                   generator=None, probe=None, atol=1e-4, rtol=1e-4,
                   max_steps=2000):
    """The log-likelihood of x (per image) under the model's
    probability-flow ODE from sigma_min to sigma_max: a gaussian prior of
    std sigma_max at the end, plus the integrated divergence. The probe is
    ``probe`` or a Rademacher draw from ``generator``. Returns (ll, info),
    info {"fevals", "steps", "nfe", "naccept"}."""
    if probe is None:
        probe = torch.randint(0, 2, x.shape, generator=generator,
                              device=x.device).to(x.dtype) * 2 - 1

    def ode_fn(sigma, state):
        return flow_and_divergence(model, state[0], sigma, probe, extra_args)

    (latent, delta_ll), info = odeint_dopri5(
        ode_fn, (x, x.new_zeros([x.shape[0]])), sigma_min, sigma_max,
        rtol=rtol, atol=atol, max_steps=max_steps)
    d = latent.reshape(x.shape[0], -1)
    ll_prior = (-0.5 * (d / sigma_max) ** 2 - 0.5 * math.log(2 * math.pi)
                - math.log(sigma_max)).sum(1)
    return ll_prior + delta_ll, {"fevals": info["nfe"], **info}
