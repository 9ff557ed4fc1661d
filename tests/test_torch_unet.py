"""The port's U-Net family (k_diffusion_tpu_torch: config for image_v1,
layers' resampling, augmentation's wrapper, models/image_v1, the 2-group
param taxonomy, the train step) against the JAX package on the CPU,
float32, with the JAX weights converted by k_diffusion_tpu_torch.convert.
The model is config_cifar10.json cut to a 16x16 input, channels [64, 64,
128] and one block per level, self-attention (head dim 64) on the last two
levels. On CPU tensors the flash wrapper runs its plain version."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu import layout as j_layout
from k_diffusion_tpu.models import image_v1 as j_v1
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch.models import image_v1 as t_v1

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "config_cifar10.json"
OVERRIDES = {"input_size": [16, 16], "channels": [64, 64, 128],
             "depths": [1, 1, 1], "self_attn_depths": [False, True, True],
             "dropout_rate": 0.0}
# float32 on both sides: a module alone, and the whole model or step
MODULE_TOL = 2e-5
TOL = 2e-4
EMA_DECAY = 0.5
# the train-step optimizer eps, as tests/test_torch_train.py explains
STEP_EPS = 1e-4


def close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err,
                                                         np.abs(want).max())


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomized(params, seed):
    """Seeded noise into every kernel and bias, the zero-initialised ones
    (conv_2, out_proj, proj_out, every AdaGN mapper) included: left at
    zero, they hide the blocks. The FourierFeatures basis stays."""
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        if path[-1].key == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.sqrt(np.prod(p.shape[:-1]))
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(fill, params)


def reduced(load_config, **extra):
    config = load_config(CONFIG)
    config["model"].update(OVERRIDES, **extra)
    return config


@pytest.fixture(scope="module")
def setup():
    """(JAX config, JAX model, randomized params, port config)."""
    config = reduced(K.config.load_config)
    model = K.config.make_model(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
                                 mapping_cond=jnp.zeros((1, 9)))["params"]
    return config, model, randomized(params, 0), reduced(KT.config.load_config)


def port_model(setup, params=None):
    _, _, j_params, t_config = setup
    model = KT.config.make_model(t_config, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert.state_dict_from_jax(
        to_numpy(j_params if params is None else params)))
    return model


def jax_inner(model, params, **apply_kw):
    """The JAX U-Net behind the augment wrapper, as train.py builds it."""
    return K.augmentation.augment_wrapper_model_fn(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **apply_kw,
                                       **kw))


# ---- config -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["config_cifar10.json", "config_mnist.json",
                                  "config_32x32_small.json",
                                  "config_32x32_small_butterflies.json"])
def test_load_config_matches_jax(name):
    """The U-Net defaults, its optimizer's included (betas (0.95, 0.999),
    eps 1e-6, weight decay 1e-3)."""
    want = K.config.load_config(REPO / "configs" / name)
    assert KT.config.load_config(REPO / "configs" / name) == want


@pytest.mark.parametrize("key,value", [("cross_cond_dim", 8),
                                       ("has_variance", True)])
def test_cross_attention_and_variance_unet_match_jax(key, value):
    """The reduced cifar10 U-Net with cross-attention on its attention
    levels (a 4-token sequence, one row wholly padding) or with the
    variance head: the JAX tree converts by renaming, and the denoiser's
    output through the augment wrapper (and the log variance) match JAX."""
    extra = {key: value}
    if key == "cross_cond_dim":
        extra["cross_attn_depths"] = [False, True, True]
    config = reduced(K.config.load_config, **extra)
    model = K.config.make_model(config)
    rng = np.random.default_rng(20)
    kw = {}
    if key == "cross_cond_dim":
        padding = np.zeros((2, 4), bool)
        padding[1] = True
        kw = {"cross_cond": rng.standard_normal((2, 4, 8)).astype(np.float32),
              "cross_cond_padding": padding}
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)), jnp.ones((2,)),
        mapping_cond=jnp.zeros((2, 9)),
        **{k: jnp.asarray(v) for k, v in kw.items()})["params"]
    params = randomized(params, 21)
    t_config = reduced(KT.config.load_config, **extra)
    port = KT.config.make_model(t_config, device="cpu")
    port.load_state_dict(convert.state_dict_from_jax(to_numpy(params)))
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    sigma = np.float32([0.5, 3.0])
    inner = jax_inner(model, params, **{k: jnp.asarray(v) for k, v in kw.items()})
    want = K.config.make_denoiser_wrapper(config)(inner)(
        jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(t_config)(port.eval())(
            torch.from_numpy(x), torch.from_numpy(sigma),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    close(got, want)
    if key == "has_variance":
        want = inner(jnp.asarray(x), jnp.asarray(sigma), return_variance=True)
        with torch.no_grad():
            got = KT.augmentation.augment_wrapper_model_fn(port)(
                torch.from_numpy(x), torch.from_numpy(sigma),
                return_variance=True)
        close(got[0], want[0])
        close(got[1], want[1])


def test_parameter_count_of_cifar10():
    """config_cifar10.json at full width: the JAX model's 66,121,859
    params, of which the FourierFeatures basis (128) is a port buffer."""
    config = KT.config.load_config(CONFIG)
    model = KT.config.make_model(config, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 66_121_859 - 128
    assert model.timestep_embed.basis.numel() == 128


# ---- layers and modules ------------------------------------------------------

@pytest.mark.parametrize("kernel", ["linear", "cubic", "lanczos3", "bilinear",
                                    "bicubic"])
@pytest.mark.parametrize("direction", ["down", "up"])
def test_resample_matches_jax(kernel, direction):
    """Reflect padding, stride and the transposed conv's gain against JAX,
    on a non-square map (where an off-by-one in h or w would show)."""
    x = np.random.default_rng(1).standard_normal((2, 12, 8, 5)).astype(np.float32)
    fn = {"down": (K.layers.downsample2d, KT.layers.downsample2d),
          "up": (K.layers.upsample2d, KT.layers.upsample2d)}[direction]
    close(fn[1](torch.from_numpy(x), kernel), fn[0](jnp.asarray(x), kernel),
          MODULE_TOL)


def module_parity(j_module, t_module, x, cond, **kw):
    """Randomized JAX params into both modules; returns (port, JAX) outputs
    on the same x and cond."""
    params = j_module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(cond), **kw)["params"]
    params = randomized(params, 2)
    t_module.load_state_dict(convert.state_dict_from_jax(to_numpy(params)))
    want = j_module.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                          **kw)
    with torch.no_grad():
        got = t_module(torch.from_numpy(x), torch.from_numpy(cond),
                       torch.float32)
    return got, want


def block_inputs(c, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, c)).astype(np.float32),
            rng.standard_normal((2, 32)).astype(np.float32))


def test_adagn_matches_jax():
    x, cond = block_inputs(64)
    got, want = module_parity(j_v1.AdaGN(2), t_v1.AdaGN(64, 32, 2), x, cond)
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("c_in,c_out", [(64, 64), (96, 64)])
def test_res_conv_block_matches_jax(c_in, c_out):
    """With c_in != c_out the orthogonal 1x1 skip runs."""
    x, cond = block_inputs(c_in)
    got, want = module_parity(
        j_v1.ResConvBlock(128, c_out),
        t_v1.ResConvBlock(c_in, 128, c_out, 32, device="cpu"), x, cond)
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("c", [64, 128])
def test_self_attention_2d_matches_jax(c):
    """Heads of 64, scale 1/8, through the flash wrapper's plain version."""
    x, cond = block_inputs(c)
    got, want = module_parity(
        j_v1.SelfAttention2d(c // 64),
        t_v1.SelfAttention2d(c, c // 64, 32, device="cpu"), x, cond)
    close(got, want, MODULE_TOL)


# ---- the model ---------------------------------------------------------------

def test_converter_is_a_rename(setup):
    _, _, params, _ = setup
    flat = convert.flatten(to_numpy(params))
    state = port_model(setup).state_dict()
    assert set(flat) == set(state)
    for name, value in flat.items():
        assert tuple(state[name].shape) == value.shape, name
    assert "u_net_d_1.res_0.norm_1.mapper.kernel" in state
    assert state["u_net_d_1.res_0.conv_1.kernel"].shape == (3, 3, 64, 64)


@pytest.mark.parametrize("with_aug", [False, True])
def test_denoiser_forward_matches_jax(setup, with_aug):
    config, model, params, t_config = setup
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    sigma = np.float32([0.4, 3.0])
    aug = (rng.standard_normal((2, 9)) * 0.3).astype(np.float32)
    kw_j = {"aug_cond": jnp.asarray(aug)} if with_aug else {}
    kw_t = {"aug_cond": torch.from_numpy(aug)} if with_aug else {}
    want = K.config.make_denoiser_wrapper(config)(jax_inner(model, params))(
        jnp.asarray(x), jnp.asarray(sigma), **kw_j)
    port = port_model(setup).eval()
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(t_config)(port)(
            torch.from_numpy(x), torch.from_numpy(sigma), **kw_t)
        inner = port(torch.from_numpy(x), torch.from_numpy(sigma),
                     mapping_cond=torch.zeros(2, 9))
    close(got, want)
    # the blocks matter: the model output is far from the c_skip * x skip
    assert inner.std() > 0.1


def test_patch_unet_cond_and_skip_stages_match_jax():
    """patch_size 2, a one-channel unet_cond and skip_stages 1 (the first
    level skipped, proj_in straight to the second level's width)."""
    extra = {"patch_size": 2, "unet_cond_dim": 1, "skip_stages": 1}
    config = reduced(K.config.load_config, **extra)
    model = K.config.make_model(config)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    unet = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    sigma = np.float32([0.7, 5.0])
    mc = (rng.standard_normal((2, 9)) * 0.3).astype(np.float32)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(sigma),
        mapping_cond=jnp.asarray(mc), unet_cond=jnp.asarray(unet))["params"]
    params = randomized(params, 6)
    assert "u_net_d_0" not in params
    want = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sigma),
                       mapping_cond=jnp.asarray(mc), unet_cond=jnp.asarray(unet))
    port = KT.config.make_model(reduced(KT.config.load_config, **extra),
                                device="cpu")
    port.load_state_dict(convert.state_dict_from_jax(to_numpy(params)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(sigma),
                          mapping_cond=torch.from_numpy(mc),
                          unet_cond=torch.from_numpy(unet))
    close(got, want)


def test_sample_dpmpp_2m_trajectory_matches_jax(setup):
    """10 steps through the augment wrapper (aug_cond zeros): every step's
    denoised output and the final sample."""
    config, model, params, t_config = setup
    sigmas = np.asarray(K.sampling.get_sigmas_karras(10, 1e-2, 80.0, rho=7.0))
    x = (np.random.default_rng(7).standard_normal((1, 16, 16, 3))
         * sigmas[0]).astype(np.float32)
    steps_j, steps_t = [], []
    wrap = K.config.make_denoiser_wrapper(config)(jax_inner(model, params))
    want = K.sampling.sample_dpmpp_2m(
        wrap, jnp.asarray(x), jnp.asarray(sigmas),
        callback=lambda info: steps_j.append(
            (int(info["i"]), np.asarray(info["denoised"]))))
    jax.effects_barrier()  # debug callbacks run asynchronously, unordered
    steps_j = [d for _, d in sorted(steps_j, key=lambda s: s[0])]
    denoiser = KT.config.make_denoiser_wrapper(t_config)(port_model(setup).eval())
    got = KT.sampling.sample_dpmpp_2m(
        denoiser, torch.from_numpy(x),
        KT.sampling.get_sigmas_karras(10, 1e-2, 80.0, rho=7.0, device="cpu"),
        callback=lambda info: steps_t.append(info["denoised"]))
    assert len(steps_t) == len(steps_j) == 10
    for d_t, d_j in zip(steps_t, steps_j):
        close(d_t, d_j)
    close(got, want)


def test_train_mode_draws_masks_from_the_generator(setup):
    """Dropout on: channel masks after each 3x3 conv and element masks on
    the attention output come from the generator passed in."""
    _, _, _, t_config = setup
    config = {**t_config, "model": {**t_config["model"], "dropout_rate": 0.5}}
    model = KT.config.make_model(config, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    model.load_state_dict(port_model(setup).state_dict())
    x, sigma = torch.randn(1, 16, 16, 3), torch.ones(1)
    with torch.no_grad():
        a, b, c = (model.train()(x, sigma, generator=torch.Generator().manual_seed(s))
                   for s in (2, 2, 3))
        d = model.eval()(x, sigma)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


# ---- training -----------------------------------------------------------------

def test_param_group_labels_match_jax(setup):
    """The 2-group taxonomy over named_parameters() equals JAX's over the
    param tree (the FourierFeatures basis is a JAX param, a port buffer)."""
    _, _, params, _ = setup
    flat = convert.flatten(j_v1.param_group_labels(to_numpy(params)))
    want = {k: v for k, v in flat.items() if not k.endswith(".basis")}
    assert t_v1.param_group_labels(port_model(setup)) == want
    assert set(want.values()) == {"wd", "no_wd"}


def test_train_step_matches_jax(setup):
    """Loss, every gradient, the params after one AdamW step (2 groups, the
    mapping-LR groups empty) and the EMA copy, against the JAX step with
    train.py's augment-wrapper apply_fn, from the same params, reals,
    aug_cond and draws."""
    config, model, params, t_config = setup
    config = {**config, "optimizer": {**config["optimizer"], "eps": STEP_EPS}}
    t_config = {**t_config, "optimizer": {**t_config["optimizer"],
                                          "eps": STEP_EPS}}
    rng = np.random.default_rng(8)
    reals = rng.standard_normal((1, 2, 16, 16, 3)).astype(np.float32)
    aug = (rng.standard_normal((1, 2, 9)) * 0.3).astype(np.float32)

    def apply_fn(p, x, sig, dropout_key, aug_cond=None, **kw):
        inner = K.augmentation.augment_wrapper_model_fn(
            lambda xi, si, **k: model.apply({"params": p}, xi, si, train=True,
                                            rngs={"dropout": dropout_key}, **k))
        return inner(x, sig, aug_cond=aug_cond, **kw)

    opt = K.training.make_optimizer(config, j_v1.param_group_labels(params))
    state = K.training.TrainState(
        step=jnp.int32(0), params=jax.tree_util.tree_map(jnp.array, params),
        opt_state=opt.init(params), ema_params=jax.tree_util.tree_map_with_path(
            lambda path, p: jnp.array(p) * (1.0 if path[-1].key == "basis"
                                            else 0.9), params))
    ema_before = to_numpy(state.ema_params)
    density = K.config.make_sample_density(config["model"])
    step = K.training.make_train_step(
        model, K.config.make_denoiser_wrapper(config), density, opt,
        apply_fn=apply_fn)
    key = jax.random.PRNGKey(9)
    new_state, metrics = step(state, {"reals": jnp.asarray(reals),
                                      "aug_cond": jnp.asarray(aug)}, key,
                              EMA_DECAY)
    # the draws the JAX step made from its key
    k_sigma, k_loop = jax.random.split(key)
    sigmas = np.asarray(density(k_sigma, (2,), stratified=(0, 1))).reshape(1, 2)
    k_noise, _, _ = jax.random.split(jax.random.fold_in(k_loop, 0), 3)
    folded = j_layout.fold_images(jnp.asarray(reals[0])).shape
    noise = np.asarray(jax.random.normal(k_noise, folded)).reshape(reals.shape)

    def loss_fn(p):
        den = K.config.make_denoiser_wrapper(config)(
            lambda x, s, **kw: apply_fn(p, x, s, jax.random.PRNGKey(0), **kw))
        return jnp.mean(den.loss(jnp.asarray(reals[0]), jnp.asarray(noise[0]),
                                 jnp.asarray(sigmas[0]),
                                 aug_cond=jnp.asarray(aug[0])))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    close(metrics["loss"], loss, MODULE_TOL)
    port = port_model(setup).train()
    t_loss = KT.config.make_denoiser_wrapper(t_config)(port).loss(
        torch.from_numpy(reals[0]), torch.from_numpy(noise[0]),
        torch.from_numpy(sigmas[0]), aug_cond=torch.from_numpy(aug[0])).mean()
    t_loss.backward()
    close(t_loss, loss)
    want = convert.flatten(to_numpy(grads))
    named = dict(port.named_parameters())
    assert set(named) == {k for k in want if not k.endswith(".basis")}
    for name, p in named.items():
        close(p.grad, want[name], name=name)

    model_t = port_model(setup)
    t_state = KT.training.init_train_state(
        model_t, KT.training.make_optimizer(t_config, model_t))
    assert [g["name"] for g in t_state.optimizer.optimizer.param_groups] == [
        "wd", "no_wd"]
    t_state.ema_model.load_state_dict(convert.state_dict_from_jax(ema_before))
    t_step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(t_config),
        lambda shape, stratified=None, generator=None, device=None:
        torch.from_numpy(sigmas).reshape(shape))
    t_metrics = t_step(t_state, {"reals": torch.from_numpy(reals),
                                 "aug_cond": torch.from_numpy(aug)},
                       torch.Generator().manual_seed(0), EMA_DECAY,
                       noise=torch.from_numpy(noise))
    close(t_metrics["loss"], metrics["loss"])
    assert t_state.step == int(new_state.step) == 1
    for tree, module in ((new_state.params, t_state.model),
                         (new_state.ema_params, t_state.ema_model)):
        want = convert.flatten(to_numpy(tree))
        for name, p in module.state_dict().items():
            close(p, want[name], name=name)
