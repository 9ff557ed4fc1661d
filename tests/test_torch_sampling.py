"""The port's sampler suite (k_diffusion_tpu_torch.sampling) against the
JAX package's on the CPU, in float32: every sampler on the closed-form
Gaussian denoiser with the same noise injected on both sides, the adaptive
solver's accept/reject path, three samplers on a converted tiny HDiT, the
schedules, the Brownian tree and ``call_sampler``'s dispatch."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu import sampling as JS
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch import sampling as TS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIGMA_MIN, SIGMA_MAX, STEPS = 0.01, 80.0, 10
SHAPE = (4, 64)
# float32 on both sides; the port's step coefficients come from the host in
# float64 where JAX's are float32, a few float32 roundings a step
REL = 1e-5
REL_ADAPTIVE = 1e-4
REL_MODEL = 2e-4


def rel_l2(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def gaussian_jax(x, sigma):
    """The exact posterior mean for N(0, 1) data."""
    return x / (1 + sigma.reshape(sigma.shape + (1,) * (x.ndim - 1)) ** 2)


def gaussian_torch(x, sigma):
    return x / (1 + KT.utils.append_dims(sigma, x.ndim) ** 2)


def noise_tables(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]


def jax_noise(tables):
    """noise(sigma, sigma_next): the same deterministic function of the two
    sigmas on both sides, whatever order or count the sampler calls it in."""
    n0, n1 = map(jnp.asarray, tables)
    return lambda key, s, sn: (n0 * jnp.cos(3 * jnp.log1p(s))
                               + n1 * jnp.sin(5 * jnp.log1p(sn)))


def torch_noise(tables):
    n0, n1 = map(torch.from_numpy, tables)
    return lambda s, sn: (n0 * math.cos(3 * math.log1p(s))
                          + n1 * math.sin(5 * math.log1p(sn)))


def inputs():
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    sigmas = np.array(JS.get_sigmas_karras(STEPS, SIGMA_MIN, SIGMA_MAX))
    return x * SIGMA_MAX, sigmas


# (name, keyword arguments for both, whether the noise is injected); churn 0
CASES = [
    ("euler", {}, False),
    ("euler_ancestral", {}, True),
    ("heun", {}, False),
    ("dpm_2", {}, False),
    ("dpm_2_ancestral", {}, True),
    ("lms", {}, False),
    ("dpm_fast", {}, False),
    ("dpm_fast", {"eta": 0.5}, True),
    ("dpm_adaptive", {}, False),
    ("dpmpp_2s_ancestral", {}, True),
    ("dpmpp_sde", {}, True),
    ("dpmpp_2m", {}, False),
    ("dpmpp_2m_sde", {}, True),
    ("dpmpp_2m_sde", {"solver_type": "heun"}, True),
    ("dpmpp_3m_sde", {}, True),
]


def run_both(name, kwargs, noisy, x, sigmas):
    """The JAX and the port's sampler on the same inputs (the DPM-Solver
    drivers on the schedule's range, dpm_fast with its step count)."""
    jfn, tfn = getattr(JS, f"sample_{name}"), getattr(TS, f"sample_{name}")
    jkw, tkw = dict(kwargs), dict(kwargs)
    if noisy:
        tables = noise_tables()
        jkw["noise_sampler"], tkw["noise_sampler"] = (jax_noise(tables),
                                                      torch_noise(tables))
    if "key" in jfn.__code__.co_varnames:
        jkw["key"] = jax.random.PRNGKey(0)
    if name in ("dpm_fast", "dpm_adaptive"):
        lo, hi = float(sigmas[-2]), float(sigmas[0])
        jargs = targs = (lo, hi) + ((STEPS,) if name == "dpm_fast" else ())
    else:
        jargs, targs = (jnp.asarray(sigmas),), (torch.from_numpy(sigmas),)
    want = jfn(gaussian_jax, jnp.asarray(x), *jargs, **jkw)
    got = tfn(gaussian_torch, torch.from_numpy(x), *targs, **tkw)
    return got, want


@pytest.mark.parametrize("name,kwargs,noisy", CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}"
                              for n, k, _ in CASES])
def test_sampler_matches_jax(name, kwargs, noisy):
    x, sigmas = inputs()
    got, want = run_both(name, kwargs, noisy, x, sigmas)
    assert np.isfinite(got.numpy()).all()
    assert rel_l2(got, want) <= (REL_ADAPTIVE if name == "dpm_adaptive"
                                 else REL)


# the default; a tighter tolerance; order 2; large first steps; a stricter
# accept threshold: between them every branch of the controller, each
# rejecting some steps but the first. With a first step of h = 5 the output
# is held at 1e-3: that step cancels x (about 80) against sigma expm1(h) eps
# (about 79), and x_low against x_high, which magnifies a one-ulp
# difference between XLA's float32 exp and numpy's some 1e4 times
ADAPTIVE = [({}, REL_ADAPTIVE), ({"rtol": 0.002}, REL_ADAPTIVE),
            ({"order": 2, "h_init": 3.0}, REL_ADAPTIVE),
            ({"h_init": 5.0}, 1e-3), ({"accept_safety": 0.95}, REL_ADAPTIVE),
            ({"rtol": 0.01, "h_init": 1.0}, REL_ADAPTIVE)]


@pytest.mark.parametrize("kwargs,bound", ADAPTIVE,
                         ids=[str(k) or "default" for k, _ in ADAPTIVE])
def test_dpm_adaptive_takes_jax_accept_reject_path(kwargs, bound):
    """The same sequence of accepted and rejected steps as JAX's
    while_loop, so the same model evaluations, and the output within
    1e-4 (the first step at h = 5: 1e-3, above)."""
    x, sigmas = inputs()
    lo, hi = float(sigmas[-2]), float(sigmas[0])
    jsteps, tsteps = [], []
    want, jinfo = JS.sample_dpm_adaptive(
        gaussian_jax, jnp.asarray(x), lo, hi, return_info=True,
        callback=lambda d: jsteps.append(int(d["n_accept"])), **kwargs)
    jax.effects_barrier()
    got, info = TS.sample_dpm_adaptive(
        gaussian_torch, torch.from_numpy(x), lo, hi, return_info=True,
        callback=lambda d: tsteps.append(d["n_accept"]), **kwargs)
    assert tsteps == jsteps
    assert {k: int(v) for k, v in jinfo.items()} == info
    assert info["nfe"] == kwargs.get("order", 3) * info["steps"]
    if kwargs:
        assert info["n_reject"] > 0
    assert rel_l2(got, want) <= bound


def test_dpm_adaptive_with_noise_takes_jax_path():
    """eta > 0 with the same noise injected: the same accept/reject
    sequence. The output is held at 1e-3: its noise scale sqrt(sigma(t)^2 -
    sigma(t')^2) is a float32 difference of near-equal numbers, which
    magnifies the controller's rounding-level differences in t."""
    x, sigmas = inputs()
    tables = noise_tables()
    lo, hi = float(sigmas[-2]), float(sigmas[0])
    jsteps, tsteps = [], []
    want, jinfo = JS.sample_dpm_adaptive(
        gaussian_jax, jnp.asarray(x), lo, hi, eta=0.7,
        key=jax.random.PRNGKey(0), noise_sampler=jax_noise(tables),
        return_info=True, callback=lambda d: jsteps.append(int(d["n_accept"])))
    jax.effects_barrier()
    got, info = TS.sample_dpm_adaptive(
        gaussian_torch, torch.from_numpy(x), lo, hi, eta=0.7,
        noise_sampler=torch_noise(tables), return_info=True,
        callback=lambda d: tsteps.append(d["n_accept"]))
    assert tsteps == jsteps and info["n_reject"] > 0
    assert {k: int(v) for k, v in jinfo.items()} == info
    assert rel_l2(got, want) <= 1e-3


@pytest.mark.parametrize("name,args", [
    ("karras", (STEPS, SIGMA_MIN, SIGMA_MAX)),
    ("karras", (7, 0.002, 160.0, 5.0)),
    ("exponential", (STEPS, SIGMA_MIN, SIGMA_MAX)),
    ("polyexponential", (STEPS, SIGMA_MIN, SIGMA_MAX)),
    ("polyexponential", (STEPS, SIGMA_MIN, SIGMA_MAX, 2.0)),
    ("vp", (STEPS,)),
    ("vp", (STEPS, 12.0, 0.2, 1e-2)),
])
def test_schedules_match_jax(name, args):
    """Within 1e-6 of the schedule's largest sigma: both compute in
    float32, JAX's power x ** rho through exp and log, a few ulps from the
    port's."""
    want = np.asarray(getattr(JS, f"get_sigmas_{name}")(*args))
    got = getattr(TS, f"get_sigmas_{name}")(*args, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got[-1] == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())


@pytest.mark.parametrize("sigma_from,sigma_to,eta", [
    (2.0, 1.0, 1.0), (2.0, 1.0, 0.5), (2.0, 1.0, 0.0), (5.0, 0.0, 1.0)])
def test_ancestral_step_matches_jax(sigma_from, sigma_to, eta):
    want = JS.get_ancestral_step(jnp.float32(sigma_from),
                                 jnp.float32(sigma_to), eta)
    got = TS.get_ancestral_step(sigma_from, sigma_to, eta)
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=1e-6,
                               atol=1e-7)
    assert abs(got[0] ** 2 + got[1] ** 2 - sigma_to ** 2) <= 1e-9


def test_linear_multistep_coeff_matches_jax():
    _, sigmas = inputs()
    t = np.asarray(sigmas, np.float64)
    for i in range(STEPS):
        order = min(i + 1, 4)
        for j in range(order):
            assert (TS.linear_multistep_coeff(order, t, i, j)
                    == JS.linear_multistep_coeff(order, t, i, j))
    with pytest.raises(ValueError, match="too high"):
        TS.linear_multistep_coeff(4, t, 1, 0)


# --- the Brownian tree ---

def test_brownian_tree_additivity_and_anchor():
    tree = TS.VirtualBrownianTree(3, 0.0, 10.0, (4, 8), device="cpu")
    w_25, w_50, w_75 = tree(2.5), tree(5.0), tree(7.5)
    torch.testing.assert_close(w_75 - w_25, (w_50 - w_25) + (w_75 - w_50),
                               atol=1e-5, rtol=0)
    assert torch.count_nonzero(tree(0.0)) == 0


def test_brownian_tree_determinism_and_step_invariance():
    x = torch.zeros((2, 16))
    ns = TS.BrownianTreeNoiseSampler(x, 0.01, 10.0, 7)
    torch.testing.assert_close(ns(5.0, 2.0), ns(5.0, 2.0), atol=0, rtol=0)
    # a second sampler with the same seed, queried in another order
    other = TS.BrownianTreeNoiseSampler(x, 0.01, 10.0, 7)
    fine = [other(3.0, 1.0), other(5.0, 3.0)]
    w_coarse = ns(5.0, 1.0) * 4.0 ** 0.5
    w_f1, w_f2 = fine[1] * 2.0 ** 0.5, fine[0] * 2.0 ** 0.5
    torch.testing.assert_close(w_coarse, w_f1 + w_f2, atol=1e-4, rtol=0)
    assert not torch.equal(ns(5.0, 2.0),
                           TS.BrownianTreeNoiseSampler(x, 0.01, 10.0, 8)(5.0, 2.0))


def test_brownian_tree_values_do_not_depend_on_the_query_order():
    """The tree keeps its last values: any order of queries gives each
    (seed, t) the value a fresh tree gives it."""
    tree = TS.VirtualBrownianTree(5, 0.0, 4.0, (3, 7), device="cpu")
    for t in (1.0, 2.5, 1.0, 3.0, 2.5, 1.0, 0.5, 3.0):
        fresh = TS.VirtualBrownianTree(5, 0.0, 4.0, (3, 7), device="cpu")
        assert torch.equal(tree(t), fresh(t))


def test_brownian_tree_variance():
    tree = TS.VirtualBrownianTree(11, 0.0, 1.0, (50000,), device="cpu")
    w = tree(0.37).numpy()
    assert abs(w.var() - 0.37) < 0.02
    assert abs(w.mean()) < 0.02


def test_brownian_noise_is_the_same_for_any_step_count():
    """An SDE sampler's default noise comes from a Brownian tree seeded
    from its generator: the noise over [sigma_max, sigma_min] of a 10-step
    run equals the sum of a 20-step run's, scaled."""
    x = torch.zeros(SHAPE)
    seeds = []
    for steps in (10, 20):
        g = torch.Generator().manual_seed(4)
        sigmas = TS.get_sigmas_karras(steps, SIGMA_MIN, SIGMA_MAX, device="cpu")
        seeds.append(TS._brownian_default(x, sigmas, g, None).tree.seed)
    assert seeds[0] == seeds[1]


# --- the model path and dispatch ---

TINY = REPO / "configs" / "config_test_tiny.json"


def randomized(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        if path[-1].key == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.float32(np.sqrt(p.shape[0]))
        return p * (1 + np.float32(0.1) * noise)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def tiny_models():
    """config_test_tiny (class-conditional, head dim 32) in JAX with
    randomized params, and the port's model with those params."""
    config = K.config.load_config(TINY)
    model = K.config.make_model(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)),
                                 class_cond=jnp.zeros((1,), jnp.int32))
    params = randomized(params["params"], 1)
    tconfig = KT.config.load_config(TINY)
    port = KT.config.make_model(tconfig, device="cpu").eval()
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return config, model, params, tconfig, port


@pytest.mark.parametrize("name", ["dpmpp_2m", "lms", "dpmpp_2m_sde"])
def test_sampler_on_tiny_hdit_matches_jax(tiny_models, name):
    config, model, params, tconfig, port = tiny_models
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 32, 32, 3)) * 80).astype(np.float32)
    classes = np.int32([1, 3])
    sigmas = np.array(JS.get_sigmas_karras(6, 0.01, 80.0))
    jden = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **kw))
    tden = KT.config.make_denoiser_wrapper(tconfig)(port)
    jkw, tkw = {}, {}
    if name == "dpmpp_2m_sde":
        rng = np.random.default_rng(6)
        tables = [rng.standard_normal(x.shape).astype(np.float32)
                  for _ in range(2)]
        n0, n1 = tables
        jkw = {"key": jax.random.PRNGKey(0), "noise_sampler":
               lambda key, s, sn: (jnp.asarray(n0) * jnp.cos(3 * jnp.log1p(s))
                                   + jnp.asarray(n1) * jnp.sin(5 * jnp.log1p(sn)))}
        tkw = {"noise_sampler": lambda s, sn: (
            torch.from_numpy(n0) * math.cos(3 * math.log1p(s))
            + torch.from_numpy(n1) * math.sin(5 * math.log1p(sn)))}
    want = getattr(JS, f"sample_{name}")(
        jden, jnp.asarray(x), jnp.asarray(sigmas),
        extra_args={"class_cond": jnp.asarray(classes)}, **jkw)
    got = getattr(TS, f"sample_{name}")(
        tden, torch.from_numpy(x), torch.from_numpy(sigmas),
        extra_args={"class_cond": torch.from_numpy(classes).long()}, **tkw)
    assert rel_l2(got, want) <= REL_MODEL


@pytest.mark.parametrize("name", TS.SAMPLERS)
def test_call_sampler_runs_every_sampler(name):
    """All 13 of the JAX package's samplers by name, the DPM-Solver drivers
    on the schedule's range; each matches a direct call."""
    x, sigmas = inputs()
    xt, st = torch.from_numpy(x), torch.from_numpy(sigmas)
    got = TS.call_sampler(name, gaussian_torch, xt, st,
                          generator=torch.Generator().manual_seed(0))
    fn = getattr(TS, f"sample_{name}")
    g = torch.Generator().manual_seed(0)
    if name == "dpm_fast":
        want = fn(gaussian_torch, xt, float(sigmas[-2]), float(sigmas[0]),
                  STEPS)
    elif name == "dpm_adaptive":
        want = fn(gaussian_torch, xt, float(sigmas[-2]), float(sigmas[0]))
    elif name in ("euler", "heun", "dpm_2", "lms", "dpmpp_2m"):
        want = fn(gaussian_torch, xt, st)
    else:
        want = fn(gaussian_torch, xt, st, generator=g)
    assert got.shape == xt.shape and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_call_sampler_dispatch():
    x, sigmas = inputs()
    xt, st = torch.from_numpy(x), torch.from_numpy(sigmas)
    with pytest.raises(ValueError, match="unknown sampler"):
        TS.call_sampler("nope", gaussian_torch, xt, st)
    # a deterministic sampler takes no generator, and call_sampler gives it
    # none
    TS.call_sampler("lms", gaussian_torch, xt, st,
                    generator=torch.Generator())
    # a stochastic sampler without a generator or noise raises
    with pytest.raises(ValueError, match="generator"):
        TS.call_sampler("euler_ancestral", gaussian_torch, xt, st)


def test_call_sampler_passes_a_type_error_through():
    """A TypeError raised inside the model reaches the caller once: the
    dispatcher reads the signature and never retries."""
    calls = []

    def broken(x, sigma):
        calls.append(1)
        raise TypeError("inside the model")

    x, sigmas = inputs()
    with pytest.raises(TypeError, match="inside the model"):
        TS.call_sampler("euler_ancestral", broken, torch.from_numpy(x),
                        torch.from_numpy(sigmas),
                        generator=torch.Generator())
    assert len(calls) == 1


def test_dpm_solver_class_matches_jax():
    x, sigmas = inputs()
    t0, t1 = -math.log(10.0), -math.log(1.0)
    jsolver = JS.DPMSolver(gaussian_jax)
    tsolver = TS.DPMSolver(gaussian_torch)
    for step in ("dpm_solver_1_step", "dpm_solver_2_step",
                 "dpm_solver_3_step"):
        want = getattr(jsolver, step)(jnp.asarray(x), jnp.float32(t0),
                                      jnp.float32(t1))
        got = getattr(tsolver, step)(torch.from_numpy(x), t0, t1)
        assert rel_l2(got, want) <= REL
    want = jsolver.dpm_solver_fast(jnp.asarray(x), t0, t1, 6)
    got = tsolver.dpm_solver_fast(torch.from_numpy(x), t0, t1, 6)
    assert rel_l2(got, want) <= REL
    want, jinfo = jsolver.dpm_solver_adaptive(jnp.asarray(x), t0, t1)
    got, info = tsolver.dpm_solver_adaptive(torch.from_numpy(x), t0, t1)
    assert {k: int(v) for k, v in jinfo.items()} == info
    assert rel_l2(got, want) <= REL_ADAPTIVE
