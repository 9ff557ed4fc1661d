"""The port's engine modules against the JAX package's (CPU, float32):
``utils.transfer_params`` (progressive growing of the U-Net), ``guidance``
and ``external`` around toy inner models, ``ode.odeint_dopri5``, and
``log_likelihood`` on the closed-form gaussian denoiser (against JAX and
against the analytic density) and its divergence term on a tiny HDiT
(against JAX's ``jax.jvp``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import convert, external, guidance, ode

torch.set_num_threads(2)

j_guidance = importlib.import_module("k_diffusion_tpu.guidance")
j_external = importlib.import_module("k_diffusion_tpu.external")
j_ode = importlib.import_module("k_diffusion_tpu.ode")
j_iv1 = importlib.import_module("k_diffusion_tpu.models.image_v1")
j_itv2 = importlib.import_module("k_diffusion_tpu.models.image_transformer_v2")
j_pallas = importlib.import_module("k_diffusion_tpu.ops.pallas")

# float32 on both sides: elementwise schedule math, and a model or an ODE
OP_TOL = 1e-5
TOL = 2e-4


def close(got, want, tol=OP_TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- transfer_params --------------------------------------------------------


def test_transfer_params_counts_and_tensors_match_jax():
    """tests/test_model_families.py's case: a U-Net grown by skip_stages=1
    takes every tensor whose name and shape survive; counts and the merged
    tensors as JAX's."""
    kw = dict(c_in=3, feats_in=32, depths=(1, 1, 1), channels=(16, 32, 32),
              self_attn_depths=(False, False, True))
    key = jax.random.PRNGKey(0)
    model = j_iv1.ImageDenoiserModelV1(**kw)
    v = model.init(key, jnp.zeros((1, 32, 32, 3)), jnp.ones([1]))["params"]
    grown = j_iv1.ImageDenoiserModelV1(**kw, skip_stages=1)
    v2 = grown.init(jax.random.fold_in(key, 1), jnp.zeros((1, 16, 16, 3)),
                    jnp.ones([1]))["params"]
    want, n_want, total_want = K.utils.transfer_params(v2, v)

    def port(params, **extra):
        m = KT.models.ImageDenoiserModelV1(**kw, **extra, device="cpu")
        m.load_state_dict(convert.state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        return m

    old, new = port(v), port(v2, skip_stages=1)
    merged, n, total = KT.utils.transfer_params(new.state_dict(),
                                                old.state_dict())
    assert (n, total) == (n_want, total_want) and n > total * 0.5
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, want))
    assert set(merged) == set(want)
    for name, tensor in merged.items():
        np.testing.assert_array_equal(tensor.numpy(), want[name])
    new.load_state_dict(merged)
    with torch.no_grad():
        out = new(torch.zeros((1, 16, 16, 3)), torch.ones(1))
    assert out.shape == (1, 16, 16, 3)


# ---- guidance ---------------------------------------------------------------

NUM_CLASSES = 3


def j_toy(x, sigma, class_cond=None):
    out = x * jnp.tanh(sigma)[:, None, None, None]
    if class_cond is not None:
        out = out + 0.1 * class_cond.astype(jnp.float32)[:, None, None, None]
    return out


def t_toy(x, sigma, class_cond=None):
    out = x * torch.tanh(sigma)[:, None, None, None]
    if class_cond is not None:
        out = out + 0.1 * class_cond.float()[:, None, None, None]
    return out


def test_spherical_dist_loss_matches_jax():
    x, y = rand(1, 4, 8), rand(2, 4, 8)
    close(guidance.spherical_dist_loss(t(x), t(y)),
          j_guidance.spherical_dist_loss(x, y))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_cfg_model_fn_matches_jax(scale):
    x, sigma = rand(3, 2, 4, 4, 3), np.float32([0.5, 2.0])
    classes = np.int32([0, 2])
    j_fn = j_guidance.make_cfg_model_fn(j_toy, scale, NUM_CLASSES)
    t_fn = guidance.make_cfg_model_fn(t_toy, scale, NUM_CLASSES)
    if scale == 1:
        assert t_fn is t_toy
    close(t_fn(t(x), t(sigma), class_cond=t(classes).long()),
          j_fn(x, sigma, class_cond=classes))


def test_cond_and_static_thresh_model_fns_match_jax():
    """cond_fn is the gradient of a spherical distance of the denoised
    image to a target, through torch.autograd.grad here and jax.grad
    there."""
    x, sigma, target = rand(4, 2, 4, 4, 3), np.float32([0.5, 2.0]), rand(5, 2, 48)

    def j_cond(x, sigma, denoised=None, **kw):
        loss = lambda x: j_guidance.spherical_dist_loss(
            j_toy(x, sigma).reshape(2, -1), target).sum()
        return -jax.grad(loss)(x)

    def t_cond(x, sigma, denoised=None, **kw):
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            loss = guidance.spherical_dist_loss(
                t_toy(x, sigma).reshape(2, -1), t(target)).sum()
            return -torch.autograd.grad(loss, x)[0]

    want = j_guidance.make_cond_model_fn(j_toy, j_cond)(x, sigma)
    close(guidance.make_cond_model_fn(t_toy, t_cond)(t(x), t(sigma)), want)
    close(guidance.make_static_thresh_model_fn(t_toy, 0.3)(t(x), t(sigma)),
          j_guidance.make_static_thresh_model_fn(j_toy, 0.3)(x, sigma))


# ---- external ---------------------------------------------------------------


def alphas_cumprod():
    betas = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
    return np.cumprod(1 - betas).astype(np.float32)


def j_inner(x, t_, cond=None, **kw):
    out = x * jnp.cos(t_ / 1000)[:, None, None, None] + 0.01 * t_[:, None, None, None] / 1000
    return out if cond is None else out + cond


def t_inner(x, t_, cond=None, **kw):
    out = x * torch.cos(t_ / 1000)[:, None, None, None] + 0.01 * t_[:, None, None, None] / 1000
    return out if cond is None else out + cond


def j_inner2(x, t_, **kw):
    return jnp.concatenate([j_inner(x, t_), 7 + x], axis=-1)


def t_inner2(x, t_, **kw):
    return torch.cat([t_inner(x, t_), 7 + x], dim=-1)


WRAPPERS = {
    "v": (lambda m, a: j_external.VDenoiser(m),
          lambda m, a: external.VDenoiser(m), j_inner, t_inner),
    "eps": (lambda m, a: j_external.DiscreteEpsDDPMDenoiser(m, jnp.asarray(a), False),
            lambda m, a: external.DiscreteEpsDDPMDenoiser(m, t(a), False),
            j_inner, t_inner),
    "eps_quantized": (
        lambda m, a: j_external.DiscreteEpsDDPMDenoiser(m, jnp.asarray(a), True),
        lambda m, a: external.DiscreteEpsDDPMDenoiser(m, t(a), True),
        j_inner, t_inner),
    "openai": (lambda m, a: j_external.OpenAIDenoiser(m, a),
               lambda m, a: external.OpenAIDenoiser(m, a), j_inner2, t_inner2),
    "compvis": (lambda m, a: j_external.CompVisDenoiser(m, jnp.asarray(a)),
                lambda m, a: external.CompVisDenoiser(m, t(a)), j_inner, t_inner),
    "v_ddpm": (lambda m, a: j_external.DiscreteVDDPMDenoiser(m, jnp.asarray(a), False),
               lambda m, a: external.DiscreteVDDPMDenoiser(m, t(a), False),
               j_inner, t_inner),
    "compvis_v": (lambda m, a: j_external.CompVisVDenoiser(m, jnp.asarray(a)),
                  lambda m, a: external.CompVisVDenoiser(m, t(a)), j_inner, t_inner),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_external_wrapper_matches_jax(name):
    """The denoised output and the loss at sigmas inside the schedule."""
    make_j, make_t, j_m, t_m = WRAPPERS[name]
    a = alphas_cumprod()
    j_den, t_den = make_j(j_m, a), make_t(t_m, a)
    x, noise = rand(6, 2, 4, 4, 3), rand(7, 2, 4, 4, 3)
    sigma = np.float32([0.3, 9.0])
    close(t_den(t(x), t(sigma)), j_den(x, sigma), name="call")
    close(t_den.loss(t(x), t(noise), t(sigma)),
          j_den.loss(x, noise, sigma), name="loss")
    if name == "compvis_v":
        cond = rand(8, 2, 4, 4, 3)
        close(t_den(t(x), t(sigma), cond=t(cond)),
              j_den(x, sigma, cond=cond), name="cond")


@pytest.mark.parametrize("quantize", [False, True])
def test_discrete_schedule_matches_jax(quantize):
    a = alphas_cumprod()
    sigmas = ((1 - a) / a) ** 0.5
    j_s = j_external.DiscreteSchedule(sigmas, quantize)
    t_s = external.DiscreteSchedule(t(sigmas), quantize)
    query = np.float32([sigmas[0], 0.05, 0.7, 3.3, 40.0, sigmas[-1]])
    close(t_s.sigma_to_t(t(query)), j_s.sigma_to_t(jnp.asarray(query)),
          name="sigma_to_t")
    steps = np.float32([0.0, 10.5, 500.25, 998.9, 999.0])
    close(t_s.t_to_sigma(t(steps)), j_s.t_to_sigma(jnp.asarray(steps)),
          name="t_to_sigma")
    close(t_s.get_sigmas(), j_s.get_sigmas(), name="get_sigmas")
    close(t_s.get_sigmas(25), j_s.get_sigmas(25), name="get_sigmas(25)")
    close(t_s.sigma_min, j_s.sigma_min)
    close(t_s.sigma_max, j_s.sigma_max)


def test_v_denoiser_time_maps_match_jax():
    sigma = np.float32([0.01, 1.0, 80.0])
    j_v, t_v = j_external.VDenoiser(j_inner), external.VDenoiser(t_inner)
    close(t_v.sigma_to_t(t(sigma)), j_v.sigma_to_t(sigma))
    close(t_v.t_to_sigma(t_v.sigma_to_t(t(sigma))), sigma, 1e-4)


# ---- ode --------------------------------------------------------------------


@pytest.mark.parametrize("rtol", [1e-3, 1e-4, 1e-5, 1e-6])
def test_odeint_dopri5_matches_jax_with_the_same_nfe(rtol):
    """y' = -(1 + t) y on (3, 4) gaussian states: the step counts (some
    rejected), nfe and the end state against the JAX integrator's."""
    y0 = rand(9, 3, 4)
    want, info = j_ode.odeint_dopri5(lambda t_, y: -y * (1 + t_),
                                     jnp.asarray(y0), 0.0, 3.0, rtol=rtol,
                                     atol=rtol)
    got, t_info = ode.odeint_dopri5(lambda t_, y: -y * (1 + t_), t(y0), 0.0,
                                    3.0, rtol=rtol, atol=rtol)
    assert t_info == {k: int(v) for k, v in info.items()}
    assert t_info["steps"] > t_info["naccept"]
    # the step sizes follow float32 error ratios, which XLA rounds its own
    # way: the two end states agree within a tenth of the distance of
    # JAX's from the exact solution, y0 * exp(-(t + t^2 / 2))
    exact = y0.astype(np.float64) * np.exp(-(3.0 + 4.5))
    close(got, want, 0.1 * np.abs(np.asarray(want) - exact).max()
          / np.abs(exact).max())


def test_odeint_dopri5_on_a_tuple_state_matches_jax_op_by_op():
    """A pair of states, t in the derivative, a rejected step: against the
    JAX integrator run op by op (``jax.disable_jit``). Compiled, XLA
    rounds the error estimate, a difference of nearly cancelling stages,
    its own way, and a ratio near 1 can decide another step there."""
    y0 = (rand(9, 3, 4), np.float32([1.0, -2.0]))

    def j_f(t_, y):
        return (-y[0] * jnp.cos(3 * t_) + 0.5 * jnp.sin(y[0]),
                -0.5 * y[1] * t_)

    def t_f(t_, y):
        return (-y[0] * torch.cos(torch.tensor(3 * t_)) + 0.5 * torch.sin(y[0]),
                -0.5 * y[1] * t_)

    with jax.disable_jit():
        want, info = j_ode.odeint_dopri5(j_f, y0, 0.0, 2.5, rtol=1e-5,
                                         atol=1e-6)
    got, t_info = ode.odeint_dopri5(t_f, tuple(map(t, y0)), 0.0, 2.5,
                                    rtol=1e-5, atol=1e-6)
    assert t_info == {k: int(v) for k, v in info.items()}
    assert t_info["steps"] > t_info["naccept"]
    for g, w in zip(got, want):
        close(g, w, TOL)


def gaussian_denoiser(x, sigma):
    """The exact posterior mean for N(0, 1) data."""
    return x / (1 + sigma ** 2)[:, None, None, None]


@pytest.fixture(scope="module")
def gaussian_case():
    x = rand(10, 2, 4, 4, 3)
    key = jax.random.PRNGKey(11)
    probe = np.asarray(jax.random.rademacher(key, x.shape, jnp.float32))
    want, info = K.log_likelihood(gaussian_denoiser, jnp.asarray(x), 0.01,
                                  80.0, key=key)
    got, t_info = KT.log_likelihood(gaussian_denoiser, t(x), 0.01, 80.0,
                                    probe=t(probe))
    return x, want, info, got, t_info


def test_log_likelihood_matches_jax(gaussian_case):
    """The same probe: ll within 1e-5 relative, the same nfe."""
    _, want, info, got, t_info = gaussian_case
    close(got, want)
    assert t_info["fevals"] == int(info["fevals"]) and t_info["nfe"] == t_info["fevals"]


def test_log_likelihood_matches_the_analytic_density(gaussian_case):
    """For N(0, 1) data the Hutchinson estimate is exact (J is a multiple
    of the identity) and the flow is linear: x at sigma_min reaches z = x *
    sqrt((1 + sigma_max^2) / (1 + sigma_min^2)) at sigma_max, so ll =
    log N(z; 0, sigma_max^2) + n / 2 * log((1 + sigma_max^2) / (1 +
    sigma_min^2)), which is log N(x; 0, 1 + sigma_min^2) but for the
    prior's variance (sigma_max^2, not 1 + sigma_max^2). Integrated at
    rtol = atol = 1e-6: within 1e-5 relative of the former and 1e-4 of
    the latter."""
    x = gaussian_case[0]
    got, _ = KT.log_likelihood(gaussian_denoiser, t(x), 0.01, 80.0,
                               probe=torch.ones(x.shape), atol=1e-6,
                               rtol=1e-6)
    x = x.astype(np.float64).reshape(2, -1)
    lo, hi = 1 + 0.01 ** 2, 1 + 80.0 ** 2
    z = x * np.sqrt(hi / lo)
    want = ((-0.5 * z ** 2 / 80.0 ** 2 - 0.5 * np.log(2 * np.pi * 80.0 ** 2))
            .sum(1) + x.shape[1] / 2 * np.log(hi / lo))
    close(got, want, 1e-5)
    density = (-0.5 * x ** 2 / lo - 0.5 * np.log(2 * np.pi * lo)).sum(1)
    close(got, density, 1e-4)


def test_log_likelihood_draws_its_probe_from_the_generator():
    x = t(rand(12, 1, 4, 4, 3))
    runs = [KT.log_likelihood(gaussian_denoiser, x, 0.01, 80.0,
                              generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1)]
    assert torch.equal(runs[0], runs[1]) and torch.isfinite(runs[0]).all()


def test_divergence_term_on_a_tiny_hdit_matches_jax_jvp():
    """d and v . (J v) for one probe at one sigma: the port's reverse-mode
    v . grad((d * v).sum()) on the eval HDiT (the kernels' plain versions)
    against the JAX package's forward-mode jax.jvp under force_xla, as its
    log_likelihood takes it."""
    levels = (j_itv2.LevelSpec(1, 64, 128, j_itv2.NeighborhoodAttentionSpec(64, 3), 0.0),
              j_itv2.LevelSpec(1, 64, 128, j_itv2.GlobalAttentionSpec(32), 0.0))
    j_model = j_itv2.ImageTransformerDenoiserModelV2(
        levels=levels, mapping=j_itv2.MappingSpec(1, 64, 128, 0.0),
        in_channels=3, out_channels=3, patch_size=(2, 2))
    x = rand(13, 2, 16, 16, 3)
    params = j_model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.ones([2]))["params"]
    rng = np.random.default_rng(14)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    probe = np.where(rng.random(x.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    sigma = 1.7

    def d_fn(xin):
        denoised = j_model.apply({"params": params}, xin, sigma * jnp.ones([2]))
        return K.sampling.to_d(xin, jnp.float32(sigma), denoised)

    with j_pallas.force_xla():
        d, jvp_v = jax.jvp(d_fn, (jnp.asarray(x),), (jnp.asarray(probe),))
    want_ll = np.asarray(jnp.sum((probe * jvp_v).reshape(2, -1), axis=1))
    port = KT.models.ImageTransformerDenoiserModelV2(
        levels=tuple(KT.models.image_transformer_v2.LevelSpec(
            l.depth, l.width, l.d_ff,
            type(l.self_attn).__name__ == "GlobalAttentionSpec"
            and KT.models.image_transformer_v2.GlobalAttentionSpec(32)
            or KT.models.image_transformer_v2.NeighborhoodAttentionSpec(64, 3),
            0.0) for l in levels),
        mapping=KT.models.image_transformer_v2.MappingSpec(1, 64, 128, 0.0),
        in_channels=3, out_channels=3, patch_size=(2, 2), device="cpu")
    port.load_state_dict(convert.state_dict_from_jax(params))
    got_d, got_ll = ode.flow_and_divergence(port.eval(), t(x), sigma, t(probe))
    close(got_d, d, TOL, "d")
    close(got_ll, want_ll, TOL, "d_ll")
