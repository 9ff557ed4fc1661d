"""The port's training path (k_diffusion_tpu_torch: utils densities,
schedules and EMA, the config factories, Denoiser losses, the HDiT's param
taxonomy, training.make_train_step, convert.load_train_state) against the
JAX package on the CPU, float32, at the reduced flagship size of
tests/test_torch_model.py. Same converted params, reals, noise and sigmas
on both sides; the JAX side's draws are reproduced from its keys."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu import layout as j_layout
from k_diffusion_tpu.models import image_transformer_v2 as j_itv2
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch.models import image_transformer_v2 as t_itv2

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "config_oxford_flowers.json"
# the flagship with 1 layer per level and half the widths, d_head 64,
# dropout off (the two frameworks draw different masks)
OVERRIDES = {"depths": [1, 1, 1], "widths": [64, 128, 256],
             "d_ffs": [192, 384, 768], "input_size": [64, 64],
             "dropout_rate": [0.0, 0.0, 0.0]}
# float32 on both sides: the bound of the reference parity tests
TOL = 2e-4
# the same closed-form float32 math on both sides
F32_TOL = 2e-5
EMA_DECAY = 0.5
# The optimizer eps of the train-step tests. AdamW's first update is
# lr * g / (|g| + eps) per element: at the flagship's eps of 1e-8 an element
# whose gradient is ~1e-10 moves by an amount that a float32 rounding of
# its gradient decides, so the post-step params could not be compared
# within TOL. At 1e-4 the update is a smooth function of the gradient;
# test_optimizer_matches_optax_given_the_same_grads holds the flagship eps.
STEP_EPS = 1e-4


def close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err,
                                                         np.abs(want).max())


def reduced(load_config):
    config = load_config(CONFIG)
    config["model"].update(OVERRIDES)
    return config


def conditioned(config):
    return {**config, "optimizer": {**config["optimizer"], "eps": STEP_EPS}}


def randomized(params, seed):
    """Seeded noise into every Dense kernel, the zero-initialised ones
    included (else the model returns c_skip * x and most gradients are 0);
    scales perturbed; FourierFeatures bases kept."""
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        name = path[-1].key
        if name == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(p.shape[0])
        return p * (1 + 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fill, params)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, JAX model, randomized params, port config)."""
    config = reduced(K.config.load_config)
    model = K.config.make_model(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3)),
                                 jnp.ones((1,)))["params"]
    return config, model, randomized(params, 0), reduced(KT.config.load_config)


def port_model(setup, params=None):
    _, _, j_params, t_config = setup
    model = KT.config.make_model(t_config, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert.state_dict_from_jax(
        to_numpy(j_params if params is None else params)))
    return model


# ---- sigma densities, given the same u -------------------------------------

DENSITIES = [
    ("lognormal", {"mean": -1.2, "std": 1.2}),
    ("loglogistic", {"loc": -0.5, "scale": 0.6, "min_value": 1e-2,
                     "max_value": 80.0}),
    ("loguniform", {"min_value": 1e-2, "max_value": 80.0}),
    ("v-diffusion", {"min_value": 1e-3, "max_value": 1e3}),
    ("cosine-interpolated", {}),
]


@pytest.mark.parametrize("kind,extra", DENSITIES)
@pytest.mark.parametrize("stratified", [None, (1, 3)])
def test_sigma_density_matches_jax_given_u(kind, extra, stratified):
    """The JAX density from a key against the port's transform of the u
    that JAX drew from the same key."""
    config = reduced(K.config.load_config)["model"]
    config["sigma_sample_density"] = {"type": kind, **extra}
    key = jax.random.PRNGKey(3)
    want = K.config.make_sample_density(config)(key, (64,),
                                                stratified=stratified)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (64,))))
    if stratified is not None:
        u = KT.utils.stratify(u, *stratified)
    transform = {"lognormal": lambda u: KT.utils.log_normal(u, -1.2, 1.2),
                 "loglogistic": lambda u: KT.utils.log_logistic(
                     u, -0.5, 0.6, 1e-2, 80.0),
                 "loguniform": lambda u: KT.utils.log_uniform(u, 1e-2, 80.0),
                 "v-diffusion": lambda u: KT.utils.v_diffusion(
                     u, 0.5, 1e-3, 1e3),
                 "cosine-interpolated": lambda u: KT.utils.cosine_interpolated(
                     u, 64, 32, 64, 0.5, 1e-3, 1e3)}[kind]
    close(transform(u), want, F32_TOL, kind)
    # the factory's own draw: the right shape, positive, finite
    got = KT.config.make_sample_density(reduced(KT.config.load_config)["model"]
                                        | {"sigma_sample_density":
                                           {"type": kind, **extra}})(
        (64,), stratified=stratified, generator=torch.Generator().manual_seed(0),
        device="cpu")
    assert got.shape == (64,) and bool((got > 0).all() & got.isfinite().all())


def test_split_log_normal_matches_jax_given_draws():
    key = jax.random.PRNGKey(4)
    want = K.utils.rand_split_log_normal(key, (64,), -1.0, 0.8, 1.4)
    k_n, k_u = jax.random.split(key)
    n = np.abs(np.asarray(jax.random.normal(k_n, (64,))))
    u = np.asarray(jax.random.uniform(k_u, (64,)))
    got = KT.utils.split_log_normal(torch.from_numpy(n), torch.from_numpy(u),
                                    -1.0, 0.8, 1.4)
    close(got, want, F32_TOL)


def test_stratified_uniform_covers_its_strata():
    u = KT.utils.stratified_uniform((8,), group=2, groups=4,
                                    generator=torch.Generator().manual_seed(0))
    strata = torch.floor(u * 32).long()
    assert strata.tolist() == list(range(2, 32, 4))


# ---- schedules and EMA ------------------------------------------------------

@pytest.mark.parametrize("sched", [
    {"type": "constant", "warmup": 0.0},
    {"type": "constant", "warmup": 0.99},
    {"type": "inverse", "inv_gamma": 20000.0, "power": 1.0, "warmup": 0.99},
    {"type": "exponential", "num_steps": 1000, "decay": 0.5, "warmup": 0.9,
     "min_lr": 1e-6},
])
def test_lr_schedule_matches_jax(sched):
    config = {"optimizer": {"lr": 5e-4}, "lr_sched": sched}
    want = K.config.make_lr_schedule(config)
    got = KT.config.make_lr_schedule(config)
    # the port evaluates in float64, the JAX package in float32
    for step in (0, 1, 2, 10, 100, 5000):
        assert math.isclose(got(step), float(want(step)), rel_tol=F32_TOL)


def test_ema_sched_matches_jax():
    config = K.config.load_config(CONFIG)
    want, got = K.config.make_ema_sched(config), KT.config.make_ema_sched(config)
    for _ in range(50):
        assert math.isclose(got.get_value(), want.get_value(), rel_tol=1e-12)
        want.step()
        got.step()
    assert got.state_dict() == want.state_dict()


def test_ema_update_matches_jax():
    rng = np.random.default_rng(5)
    params = [rng.standard_normal((7, 3)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]
    avg = [rng.standard_normal((7, 3)).astype(np.float32),
           rng.standard_normal(5).astype(np.float32)]
    want = K.utils.ema_update(params, avg, 0.9)
    got = [torch.from_numpy(a.copy()) for a in avg]
    KT.utils.ema_update([torch.from_numpy(p) for p in params], got, 0.9)
    for g, w in zip(got, want):
        close(g, w, F32_TOL)


# ---- factories and losses ---------------------------------------------------

@pytest.mark.parametrize("loss_config", ["karras", "simple"])
def test_denoiser_loss_matches_jax(setup, loss_config):
    """Denoiser.loss and SimpleLossDenoiser.loss through the reduced
    flagship, per sample."""
    config, model, params, t_config = setup
    config = {**config, "model": {**config["model"], "loss_config": loss_config}}
    t_config = {**t_config, "model": {**t_config["model"],
                                      "loss_config": loss_config}}
    rng = np.random.default_rng(6)
    reals = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    sigma = np.float32([0.3, 4.0])
    inner = lambda x, s, **kw: model.apply({"params": params}, x, s, **kw)
    want = K.config.make_denoiser_wrapper(config)(inner).loss(
        jnp.asarray(reals), jnp.asarray(noise), jnp.asarray(sigma))
    port = port_model(setup)
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(t_config)(port).loss(
            torch.from_numpy(reals), torch.from_numpy(noise),
            torch.from_numpy(sigma))
    close(got, want)


@pytest.mark.parametrize("path", ["variance", "scales_2", "scales_3"])
def test_variance_and_multiscale_loss_paths_match_jax(setup, path):
    """DenoiserWithVariance (the factory's pick for has_variance) on a
    closed-form model with a log variance, and Denoiser.loss with
    loss_scales 2 and 3 (the DCT multiscale weighting) through the reduced
    flagship, per sample."""
    config, model, params, t_config = setup
    rng = np.random.default_rng(9)
    reals = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    sigma = np.float32([0.3, 4.0])
    if path == "variance":
        extra = {"has_variance": True}
        w = np.float32(0.7)

        def j_inner(x, s, return_variance=False):
            out = jnp.tanh(x) * w
            return (out, jnp.log(s) * 0.5 - 0.2) if return_variance else out

        def t_inner(x, s, return_variance=False):
            out = torch.tanh(x) * float(w)
            return (out, torch.log(s) * 0.5 - 0.2) if return_variance else out
    else:
        extra = {"loss_scales": int(path[-1])}
        j_inner = lambda x, s, **kw: model.apply({"params": params}, x, s, **kw)
        t_inner = port_model(setup)
    config = {**config, "model": {**config["model"], **extra}}
    t_config = {**t_config, "model": {**t_config["model"], **extra}}
    want = K.config.make_denoiser_wrapper(config)(j_inner).loss(
        jnp.asarray(reals), jnp.asarray(noise), jnp.asarray(sigma))
    den = KT.config.make_denoiser_wrapper(t_config)(t_inner)
    assert type(den) is (KT.denoiser.DenoiserWithVariance if path == "variance"
                         else KT.denoiser.Denoiser)
    with torch.no_grad():
        got = den.loss(torch.from_numpy(reals), torch.from_numpy(noise),
                       torch.from_numpy(sigma))
    close(got, want)


def test_param_group_labels_match_jax(setup):
    """The 4-group taxonomy over named_parameters() equals JAX's over the
    param tree. The FourierFeatures bases are JAX params (frozen by
    stop_gradient) but port buffers, so they are left out."""
    _, _, params, _ = setup
    flat = convert.flatten(j_itv2.param_group_labels(to_numpy(params)))
    want = {k: v for k, v in flat.items() if not k.endswith(".basis")}
    got = t_itv2.param_group_labels(port_model(setup))
    assert got == want
    assert set(got.values()) == {"wd", "no_wd", "mapping_wd", "mapping_no_wd"}


def test_train_mode_routes_like_jax(setup):
    """Under model.train() a level with dropout runs the unfused chains
    (the fused plain versions are not called there), and the masks come
    from the generator passed in: the same seed gives the same output, and
    eval mode ignores dropout."""
    _, _, _, t_config = setup
    config = {**t_config, "model": {**t_config["model"],
                                    "dropout_rate": [0.0, 0.0, 0.5],
                                    "mapping_dropout_rate": 0.5}}
    model = KT.config.make_model(config, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # a fresh model's zero-init kernels output 0
        for p in model.parameters():
            if p.ndim == 2:
                p.normal_(generator=torch.Generator().manual_seed(p.numel()))
                p /= p.shape[0] ** 0.5
    x, sigma = torch.randn(1, 64, 64, 3), torch.ones(1)
    calls = []
    from k_diffusion_tpu_torch.ops.kernels import fused_ffn, fused_mapping
    orig = (fused_ffn.reference, fused_mapping.reference)
    fused_ffn.reference = lambda *a, **k: calls.append("ffn") or orig[0](*a, **k)
    fused_mapping.reference = lambda *a, **k: calls.append("map") or orig[1](*a, **k)
    try:
        model.train()
        with torch.no_grad():
            a = model(x, sigma, generator=torch.Generator().manual_seed(2))
            b = model(x, sigma, generator=torch.Generator().manual_seed(2))
            c = model(x, sigma, generator=torch.Generator().manual_seed(3))
        # levels 0 and 1: 2 FF blocks each (down, up); mid: unfused
        assert calls.count("ffn") == 3 * 4 and calls.count("map") == 0
        model.eval()
        calls.clear()
        with torch.no_grad():
            d = model(x, sigma)
        assert calls.count("ffn") == 5 and calls.count("map") == 1
    finally:
        fused_ffn.reference, fused_mapping.reference = orig
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert d.isfinite().all()


# ---- one train step against JAX --------------------------------------------

def jax_step(setup, reals, key, extra=None, **kw):
    """Runs the JAX train step on a copy of the params, with ``extra``
    batch entries beside ``reals``; returns (new state, metrics, the EMA
    before the step, the sigmas (A, B) and noise (A, B, H, W, C) it drew
    and, with ``class_cond`` in ``extra``, its class-dropout draws (A, B)
    bool, else None)."""
    config, model, params, _ = setup
    labels = j_itv2.param_group_labels(params)
    opt = K.training.make_optimizer(conditioned(config), labels)
    params = jax.tree_util.tree_map(jnp.array, params)
    # an EMA that differs from the params (the constant Fourier bases
    # aside, which the EMA of a real run always equals)
    ema = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.array(p) * (1.0 if path[-1].key == "basis" else 0.9),
        params)
    state = K.training.TrainState(
        step=jnp.int32(0), params=params, opt_state=opt.init(params),
        ema_params=ema)
    density = K.config.make_sample_density(config["model"])
    step = K.training.make_train_step(
        model, K.config.make_denoiser_wrapper(config), density, opt, **kw)
    ema_before = to_numpy(state.ema_params)
    batch = {"reals": jnp.asarray(reals),
             **{k: jnp.asarray(v) for k, v in (extra or {}).items()}}
    new_state, metrics = step(state, batch, key, EMA_DECAY)
    a, b = reals.shape[:2]
    k_sigma, k_loop = jax.random.split(key)
    sigmas = np.asarray(density(k_sigma, (a * b,), stratified=(0, 1))).reshape(a, b)
    noise, drops = [], []
    for i in range(a):
        k_noise, k_drop, _ = jax.random.split(jax.random.fold_in(k_loop, i), 3)
        folded = j_layout.fold_images(jnp.asarray(reals[i])).shape
        noise.append(np.asarray(jax.random.normal(k_noise, folded)).reshape(
            reals[i].shape))
        drops.append(np.asarray(jax.random.uniform(k_drop, (b,)))
                     < kw.get("cond_dropout_rate", 0.0))
    drops = np.stack(drops) if "class_cond" in (extra or {}) else None
    return new_state, metrics, ema_before, sigmas, np.stack(noise), drops


def port_step(setup, reals, sigmas, noise, ema_before, extra=None,
              class_drop=None, **kw):
    _, _, _, t_config = setup
    model = port_model(setup)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(conditioned(t_config), model))
    state.ema_model.load_state_dict(convert.state_dict_from_jax(ema_before))
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(t_config),
        lambda shape, stratified=None, generator=None, device=None:
        torch.from_numpy(sigmas).reshape(shape), **kw)
    batch = {"reals": torch.from_numpy(reals),
             **{k: torch.from_numpy(v) for k, v in (extra or {}).items()}}
    if "class_cond" in batch:
        batch["class_cond"] = batch["class_cond"].long()
    metrics = step(state, batch, torch.Generator().manual_seed(0), EMA_DECAY,
                   noise=torch.from_numpy(noise),
                   class_drop=(None if class_drop is None
                               else torch.from_numpy(class_drop)))
    return state, metrics


def check_state(state, new_state):
    assert state.step == int(new_state.step) == 1
    want = convert.flatten(to_numpy(new_state.params))
    for name, p in state.model.state_dict().items():
        close(p, want[name], name=name)
    want = convert.flatten(to_numpy(new_state.ema_params))
    for name, p in state.ema_model.state_dict().items():
        close(p, want[name], name=name)


def test_train_step_matches_jax(setup):
    """Loss, every gradient, the params after one AdamW step and the EMA
    copy, against the JAX step from the same params and draws."""
    config, model, params, t_config = setup
    reals = np.random.default_rng(7).standard_normal(
        (1, 2, 64, 64, 3)).astype(np.float32)
    new_state, metrics, ema_before, sigmas, noise, _ = jax_step(
        setup, reals, jax.random.PRNGKey(8))

    def loss_fn(p):
        inner = lambda x, s, **kw: model.apply(
            {"params": p}, x, s, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
        den = K.config.make_denoiser_wrapper(config)(inner)
        return jnp.mean(den.loss(jnp.asarray(reals[0]), jnp.asarray(noise[0]),
                                 jnp.asarray(sigmas[0])))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    close(metrics["loss"], loss, F32_TOL)
    port = port_model(setup).train()
    den = KT.config.make_denoiser_wrapper(t_config)(port)
    t_loss = den.loss(torch.from_numpy(reals[0]), torch.from_numpy(noise[0]),
                      torch.from_numpy(sigmas[0])).mean()
    t_loss.backward()
    close(t_loss, loss)
    want = convert.flatten(to_numpy(grads))
    named = dict(port.named_parameters())
    assert set(named) == {k for k in want if not k.endswith(".basis")}
    for name, p in named.items():
        close(p.grad, want[name], name=name)

    state, t_metrics = port_step(setup, reals, sigmas, noise, ema_before)
    close(t_metrics["loss"], metrics["loss"])
    check_state(state, new_state)


def test_unfused_train_step_matches_jax(setup, monkeypatch):
    """With KDT_TRAIN_FUSION=0 on both sides, the training forward runs the
    unfused prologue and feed-forward chains, and the NA levels go to the
    per-head ``na2d`` (K11/K12 on the card; here its plain version): the
    loss and every gradient against the JAX step's."""
    from k_diffusion_tpu_torch.ops.kernels import fused_ffn, fused_qkv
    config, model, params, t_config = setup
    monkeypatch.setenv("KDT_TRAIN_FUSION", "0")
    rng = np.random.default_rng(14)
    reals, noise = (rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
                    for _ in range(2))
    sigmas = np.float32([0.3, 4.0])

    def loss_fn(p):
        inner = lambda x, s, **kw: model.apply(
            {"params": p}, x, s, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
        den = K.config.make_denoiser_wrapper(config)(inner)
        return jnp.mean(den.loss(jnp.asarray(reals), jnp.asarray(noise),
                                 jnp.asarray(sigmas)))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = port_model(setup).train()
    calls = []
    for mod, name in ((t_itv2, "na2d"), (t_itv2, "na2d_packed"),
                      (fused_qkv, "reference"), (fused_ffn, "reference")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **kw:
                            calls.append(_n) or _o(*a, **kw))
    den = KT.config.make_denoiser_wrapper(t_config)(port)
    t_loss = den.loss(torch.from_numpy(reals), torch.from_numpy(noise),
                      torch.from_numpy(sigmas)).mean()
    t_loss.backward()
    # two NA levels, each in the down and the up stack; nothing fused
    assert calls == ["na2d"] * 4
    close(t_loss, loss)
    want = convert.flatten(to_numpy(grads))
    for name, p in port.named_parameters():
        close(p.grad, want[name], name=name)


def test_optimizer_matches_optax_given_the_same_grads(setup):
    """Clip + the 4-group AdamW at the flagship's own settings (eps 1e-8),
    fed the same gradients on both sides, over the reduced flagship's
    params; a gradient norm above 1 makes the clip act."""
    config, _, params, t_config = setup
    rng = np.random.default_rng(13)
    # the Fourier bases sit behind stop_gradient: their gradient is 0
    grads = jax.tree_util.tree_map_with_path(
        lambda path, p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(
            -12, -1, p.shape) * (path[-1].key != "basis")).astype(np.float32),
        to_numpy(params))
    opt = K.training.make_optimizer(config, j_itv2.param_group_labels(params))
    updates, _ = opt.update(grads, opt.init(params), params)
    want = convert.flatten(to_numpy(optax.apply_updates(params, updates)))
    model = port_model(setup)
    optimizer = KT.training.make_optimizer(t_config, model)
    flat = convert.flatten(grads)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(flat[name])
    norm = optimizer.step(0)
    assert norm > 1.0
    for name, p in model.state_dict().items():
        close(p, want[name], F32_TOL, name)


def test_train_step_accumulates_microbatches_like_jax(setup):
    """Two microbatches of one image: averaged gradients, the loss and
    the gradient-noise-scale norms."""
    reals = np.random.default_rng(9).standard_normal(
        (2, 1, 64, 64, 3)).astype(np.float32)
    new_state, metrics, ema_before, sigmas, noise, _ = jax_step(
        setup, reals, jax.random.PRNGKey(10), compute_gns=True)
    state, t_metrics = port_step(setup, reals, sigmas, noise, ema_before,
                                 compute_gns=True)
    for key in ("loss", "grad_sq_norm_small", "grad_sq_norm_big"):
        close(t_metrics[key], metrics[key], name=key)
    check_state(state, new_state)


def test_converted_train_state_gives_the_same_ema_forward(setup):
    """convert.load_train_state carries a JAX TrainState's params and
    ema_params: the port's EMA model computes the JAX EMA model's output."""
    config, model, params, t_config = setup
    ema = randomized(params, 11)
    port = port_model(setup)
    state = KT.training.init_train_state(
        port, KT.training.make_optimizer(t_config, port))
    convert.load_train_state(state, to_numpy(params), to_numpy(ema))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    sigma = np.float32([1.5])
    want = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": ema}, x, s, **kw))(
        jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(t_config)(state.ema_model)(
            torch.from_numpy(x), torch.from_numpy(sigma))
        online = KT.config.make_denoiser_wrapper(t_config)(state.model.eval())(
            torch.from_numpy(x), torch.from_numpy(sigma))
    close(got, want)
    assert not np.allclose(online.numpy(), np.asarray(want))


# ---- the class-conditional step, the optimizer's state, GNS ---------------

TINY = REPO / "configs" / "config_test_tiny.json"
NUM_CLASSES = 4
# config_test_tiny's rate is 0.1; at 0.5 a batch of four both keeps and
# drops labels
DROP_RATE = 0.5


def tiny_reduced(load_config):
    """configs/config_test_tiny.json with one layer."""
    config = load_config(TINY)
    config["model"]["depths"] = [1]
    return config


@pytest.fixture(scope="module")
def tiny_setup():
    """(JAX config, JAX model, randomized params, port config) of the
    reduced class-conditional config_test_tiny."""
    config = tiny_reduced(K.config.load_config)
    model = K.config.make_model(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)),
                                 class_cond=jnp.zeros((1,), jnp.int32))["params"]
    return config, model, randomized(params, 15), tiny_reduced(KT.config.load_config)


@pytest.mark.parametrize("a_steps,b", [(1, 4), (2, 2)])
def test_class_conditional_step_matches_jax(tiny_setup, a_steps, b):
    """config_test_tiny (class-conditional HDiT, augmentation cond) through
    both steps with JAX's class-dropout draws injected into the port's: the
    loss, every gradient of the microbatch-mean loss, the post-AdamW params
    and the EMA, 2e-4; at one and two microbatches."""
    config, model, params, t_config = tiny_setup
    rng = np.random.default_rng(16 + a_steps)
    reals = rng.standard_normal((a_steps, b, 32, 32, 3)).astype(np.float32)
    extra = {"class_cond": rng.integers(0, NUM_CLASSES, (a_steps, b)).astype(np.int32),
             "aug_cond": rng.standard_normal((a_steps, b, 9)).astype(np.float32)}
    kw = {"num_classes": NUM_CLASSES, "cond_dropout_rate": DROP_RATE}
    new_state, metrics, ema_before, sigmas, noise, drops = jax_step(
        tiny_setup, reals, jax.random.PRNGKey(17 + a_steps), extra, **kw)
    assert drops.any() and not drops.all()
    classes = np.where(drops, NUM_CLASSES, extra["class_cond"])

    def loss_fn(p):
        inner = lambda x, s, **k: model.apply(
            {"params": p}, x, s, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, **k)
        den = K.config.make_denoiser_wrapper(config)(inner)
        return sum(jnp.mean(den.loss(
            jnp.asarray(reals[i]), jnp.asarray(noise[i]),
            jnp.asarray(sigmas[i]), class_cond=jnp.asarray(classes[i]),
            aug_cond=jnp.asarray(extra["aug_cond"][i])))
            for i in range(a_steps)) / a_steps

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    close(metrics["loss"], loss, F32_TOL)
    port = port_model(tiny_setup).train()
    den = KT.config.make_denoiser_wrapper(t_config)(port)
    t_loss = sum(den.loss(
        torch.from_numpy(reals[i]), torch.from_numpy(noise[i]),
        torch.from_numpy(sigmas[i]),
        class_cond=torch.from_numpy(classes[i]).long(),
        aug_cond=torch.from_numpy(extra["aug_cond"][i])).mean()
        for i in range(a_steps)) / a_steps
    t_loss.backward()
    close(t_loss, loss)
    want = convert.flatten(to_numpy(grads))
    for name, p in port.named_parameters():
        close(p.grad, want[name], name=name)

    state, t_metrics = port_step(tiny_setup, reals, sigmas, noise, ema_before,
                                 extra, drops, **kw)
    close(t_metrics["loss"], metrics["loss"])
    check_state(state, new_state)


def test_class_dropout_draws_from_the_generator(tiny_setup):
    """With no injected draws the step drops labels by its generator's
    uniforms: the model sees ``num_classes`` exactly where a uniform of
    the same generator, drawn after the sigmas and the noise, is below the
    rate."""
    _, _, _, t_config = tiny_setup
    seen = []
    model = port_model(tiny_setup)
    forward = model.forward
    model.forward = lambda *a, class_cond=None, **k: seen.append(
        class_cond.clone()) or forward(*a, class_cond=class_cond, **k)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(t_config, model))
    density = KT.config.make_sample_density(t_config["model"])
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(t_config), density,
        num_classes=NUM_CLASSES, cond_dropout_rate=DROP_RATE)
    classes = torch.tensor([[0, 1, 2, 3, 0, 1, 2, 3]])
    step(state, {"reals": torch.zeros(1, 8, 32, 32, 3),
                 "class_cond": classes},
         torch.Generator().manual_seed(3), EMA_DECAY)
    g = torch.Generator().manual_seed(3)
    density((8,), stratified=(0, 1), generator=g, device="cpu")
    torch.randn((8, 32, 32, 3), generator=g)
    drop = torch.rand((8,), generator=g) < DROP_RATE
    assert torch.equal(seen[0], torch.where(drop, NUM_CLASSES, classes[0]))
    assert drop.any() and not drop.all()


def test_grouped_adamw_state_round_trip(setup):
    """state_dict -> load_state_dict into a fresh optimizer over a copy of
    the model: every moment and step count equal, and the next update
    gives the same params, bit for bit. Other groups raise."""
    _, _, _, t_config = setup
    rng = np.random.default_rng(18)
    grads = [[torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
              for p in port_model(setup).parameters()] for _ in range(3)]

    def run(model, optimizer, steps):
        for count in steps:
            for p, g in zip(model.parameters(), grads[count]):
                p.grad = g.clone()
            optimizer.step(count)
            optimizer.zero_grad()

    model = port_model(setup)
    optimizer = KT.training.make_optimizer(t_config, model)
    run(model, optimizer, [0, 1])
    saved = optimizer.state_dict()
    assert saved["groups"] == ["wd", "no_wd", "mapping_wd", "mapping_no_wd"]
    copy_model = port_model(setup)
    copy_model.load_state_dict(model.state_dict())
    restored = KT.training.make_optimizer(t_config, copy_model)
    restored.load_state_dict(saved)
    a, b = optimizer.optimizer.state, restored.optimizer.state
    for p, q in zip(model.parameters(), copy_model.parameters()):
        assert set(a[p]) == set(b[q]) == {"step", "exp_avg", "exp_avg_sq"}
        for key in a[p]:
            assert torch.equal(a[p][key], b[q][key]), key
    run(model, optimizer, [2])
    run(copy_model, restored, [2])
    for p, q in zip(model.parameters(), copy_model.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="groups"):
        restored.load_state_dict({**saved, "groups": ["wd", "no_wd"]})


def test_gradient_noise_scale_matches_jax():
    """The estimator on a sequence of (small, big) squared norms, its GNS
    and debiased stats after each update, 1e-6; and its state round
    trip."""
    rng = np.random.default_rng(19)
    want, got = K.gns.GradientNoiseScale(), KT.gns.GradientNoiseScale()
    for _ in range(20):
        small, big = rng.uniform(1.0, 2.0), rng.uniform(0.2, 1.0)
        assert math.isclose(got.update(small, big, 8, 16),
                            want.update(small, big, 8, 16), rel_tol=1e-6)
        for g, w in zip(got.get_stats(), want.get_stats()):
            assert math.isclose(g, w, rel_tol=1e-6)
    copy = KT.gns.GradientNoiseScale()
    copy.load_state_dict(got.state_dict())
    assert copy.state_dict() == got.state_dict() == want.state_dict()
    with pytest.raises(ValueError, match="strictly smaller"):
        got.update(1.0, 0.5, 8, 8)
