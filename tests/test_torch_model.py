"""The port's HDiT and DPM++(2M) path (k_diffusion_tpu_torch) against the JAX
package on the CPU, at a reduced flagship size, with the JAX weights
converted by k_diffusion_tpu_torch.convert. On CPU tensors every kernel
wrapper runs its plain version."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch.ops.kernels import global_packed

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "config_oxford_flowers.json"
# the flagship with 1 layer per level and half the widths, d_head kept at
# 64: a 64x64 image runs NA k=7 on 16x16 and 8x8 tokens, global on 4x4
OVERRIDES = {"depths": [1, 1, 1], "widths": [64, 128, 256],
             "d_ffs": [192, 384, 768], "input_size": [64, 64],
             "dropout_rate": [0.0, 0.0, 0.0]}
# float32 on both sides, the bound of the reference parity tests
TOL = 2e-4
ZERO_INIT = ("out_proj", "down_proj", "mapping_linear", "patch_out")


def reduced(load_config):
    config = load_config(CONFIG)
    config["model"].update(OVERRIDES)
    return config


def randomized(params, seed):
    """Seeded noise into every Dense kernel, the zero-initialised ones
    (out_proj, down_proj, mapping_linear, patch_out) included: left at zero,
    they make the model ignore every block and return c_skip * x, so a
    broken block would pass. Scales are perturbed; the FourierFeatures
    bases stay as JAX drew them."""
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


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX model, its randomized params, the port's model with
    those params converted)."""
    config = reduced(K.config.load_config)
    model = K.config.make_model(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3)),
                                 jnp.ones((1,)))["params"]
    params = randomized(params, 0)
    port = KT.config.make_model(reduced(KT.config.load_config), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return config, model, params, port


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_converter_is_a_rename(models):
    """Every flax param maps to a port tensor of the same name and shape
    (the FourierFeatures bases included), and nothing is left over."""
    _, _, params, port = models
    flat = convert.flatten(jax.tree_util.tree_map(np.asarray, params))
    state = port.state_dict()
    assert set(flat) == set(state)
    for name, value in flat.items():
        assert tuple(state[name].shape) == value.shape, name
    np.testing.assert_array_equal(state["time_emb.basis"].numpy(),
                                  flat["time_emb.basis"])
    assert "down_0_layer_0.self_attn.qkv_proj.kernel" in state


def test_parity_params_fill_every_zero_init_tensor(models):
    _, _, params, _ = models
    flat = convert.flatten(jax.tree_util.tree_map(np.asarray, params))
    zero_init = [n for n in flat if any(z in n for z in ZERO_INIT)]
    # 5 layers x (out_proj, down_proj, 2 mapping_linear), 2 mapping
    # down_proj, patch_out
    assert len(zero_init) == 5 * 4 + 2 + 1
    for name in zero_init:
        assert np.count_nonzero(flat[name]) == flat[name].size, name


def test_fresh_model_ignores_its_blocks():
    """The zero-init trap: a freshly initialised HDiT's output head is zero,
    so its denoiser returns exactly c_skip * x whatever the blocks do."""
    config = reduced(KT.config.load_config)
    model = KT.config.make_model(config, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.count_nonzero(model(x, torch.ones(1))) == 0


@pytest.mark.parametrize("with_aug", [False, True])
def test_denoiser_forward_matches_jax(models, with_aug):
    config, model, params, port = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    sigma = np.float32([0.4, 2.5])
    aug = (rng.standard_normal((2, 9)) * 0.3).astype(np.float32)
    kw_j = {"aug_cond": jnp.asarray(aug)} if with_aug else {}
    kw_t = {"aug_cond": torch.from_numpy(aug)} if with_aug else {}
    wrap = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **kw))
    want = wrap(jnp.asarray(x), jnp.asarray(sigma), **kw_j)
    denoiser = KT.config.make_denoiser_wrapper(config)(port)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(x), torch.from_numpy(sigma), **kw_t)
        inner = port(torch.from_numpy(x), torch.from_numpy(sigma))
    close(got, want)
    # the blocks matter: the model output is far from the c_skip * x skip
    assert inner.std() > 0.1


def test_sample_dpmpp_2m_trajectory_matches_jax(models):
    """10 steps through the reduced flagship: every step's denoised output
    and the final sample agree with JAX."""
    config, model, params, port = models
    sigmas = np.asarray(K.sampling.get_sigmas_karras(10, 1e-2, 160.0, rho=7.0))
    x = (np.random.default_rng(4).standard_normal((1, 64, 64, 3))
         * sigmas[0]).astype(np.float32)
    steps_j, steps_t = [], []
    wrap = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **kw))
    want = K.sampling.sample_dpmpp_2m(
        wrap, jnp.asarray(x), jnp.asarray(sigmas),
        callback=lambda info: steps_j.append(
            (int(info["i"]), np.asarray(info["denoised"]))))
    jax.effects_barrier()  # debug callbacks run asynchronously, unordered
    steps_j = [d for _, d in sorted(steps_j, key=lambda s: s[0])]
    denoiser = KT.config.make_denoiser_wrapper(config)(port)
    got = KT.sampling.sample_dpmpp_2m(
        denoiser, torch.from_numpy(x),
        KT.sampling.get_sigmas_karras(10, 1e-2, 160.0, rho=7.0, device="cpu"),
        callback=lambda info: steps_t.append(info["denoised"]))
    assert len(steps_t) == len(steps_j) == 10
    for d_t, d_j in zip(steps_t, steps_j):
        close(d_t, d_j)
    close(got, want)


MNIST_TRANSFORMER = REPO / "configs" / "config_mnist_transformer.json"


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the model, the schedule and the training
    density go to the card: without CUDA they raise, never falling back to
    the CPU (CUDA is made absent here whatever the machine has)."""
    config = KT.config.load_config(CONFIG)
    unet = KT.config.load_config(REPO / "configs" / "config_cifar10.json")
    density = KT.config.make_sample_density(config["model"])
    from k_diffusion_tpu_torch.models import image_transformer_v2 as itv2
    levels = (itv2.LevelSpec(1, 64, 128, itv2.GlobalAttentionSpec(64)),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: KT.config.make_model(config),
                 lambda: KT.config.make_model(unet),
                 lambda: itv2.ImageTransformerDenoiserModelV2(
                     levels, itv2.MappingSpec(1, 64, 128), 3, 3, (4, 4)),
                 lambda: KT.sampling.get_sigmas_karras(10, 1e-2, 80.0),
                 lambda: density((2,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert KT.sampling.get_sigmas_karras(10, 1e-2, 80.0,
                                         device="cpu").device.type == "cpu"


class _TorchCalled(AssertionError):
    pass


class _NoTorchCalls(torch.overrides.TorchFunctionMode):
    """Fails (_TorchCalled) on any torch function called inside it (a
    parameter allocated, a tensor made) other than naming a device."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.device:
            return func(*args, **(kwargs or {}))
        raise _TorchCalled(f"{func} ran before the compute dtype check")


def _model_constructors():
    """Each way to build a model: the flagship HDiT and the cifar10 U-Net
    through make_model, and each model class directly at a small size."""
    from k_diffusion_tpu_torch.models import image_transformer_v2 as itv2
    from k_diffusion_tpu_torch.models import image_v1
    flagship = KT.config.load_config(CONFIG)
    unet = KT.config.load_config(REPO / "configs" / "config_cifar10.json")
    levels = (itv2.LevelSpec(1, 64, 128, itv2.GlobalAttentionSpec(64)),)
    return {
        "flagship": lambda **kw: KT.config.make_model(flagship, **kw),
        "cifar10": lambda **kw: KT.config.make_model(unet, **kw),
        "hdit": lambda **kw: itv2.ImageTransformerDenoiserModelV2(
            levels, itv2.MappingSpec(1, 64, 128), 3, 3, (4, 4), **kw),
        "unet": lambda **kw: image_v1.ImageDenoiserModelV1(
            3, 16, (1, 1), (32, 64), (False, True), **kw),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("name", ["flagship", "cifar10", "hdit", "unet"])
def test_compute_dtype_other_than_bfloat16_on_the_card_raises(name, dtype):
    """No kernel takes float16: such an explicit compute dtype on a CUDA
    device is refused by name when the model is built, before any
    parameter is allocated (no torch call runs first). The kernels of the
    U-Net and of the HDiT, the flagship's neighborhood attention included,
    also have float32 forms: their float32 build on the card passes the
    check and goes on to allocate its first parameter."""
    build = _model_constructors()[name]
    if dtype == torch.float32:
        with _NoTorchCalls(), pytest.raises(_TorchCalled):
            build(dtype=dtype, device="cuda")
        return
    with _NoTorchCalls(), pytest.raises(ValueError, match="bfloat16"):
        build(dtype=dtype, device="cuda")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_default_compute_dtype_is_float32_off_the_card(device):
    """With no dtype, a model computes in float32 on the CPU and on meta,
    and the card's default is bfloat16."""
    from k_diffusion_tpu_torch.utils import compute_dtype
    assert compute_dtype(device) == torch.float32
    assert compute_dtype("cuda") == compute_dtype("cuda:0", torch.bfloat16) \
        == torch.bfloat16
    assert compute_dtype(device, torch.float16) == torch.float16
    names = ("hdit", "unet") if device == "cpu" else _model_constructors()
    for name in names:
        assert _model_constructors()[name](device=device).dtype == torch.float32


def test_global_routing_predicate():
    """The HDiT's global levels go to K3 where it takes them (head dim 64,
    s a multiple of 16 in [16, 512]) and to the flash kernel K13 otherwise:
    the flagship's 16 x 16 mid level, the mnist transformer's 7 x 7."""
    takes = global_packed.takes
    assert takes(256, 512, 8) and takes(16, 64, 1) and takes(512, 128, 2)
    assert not takes(49, 256, 4)     # config_mnist_transformer.json
    assert not takes(1024, 512, 8)   # longer than K3's shared memory holds
    assert not takes(8, 64, 1)       # shorter than one 16-row strip
    assert not takes(64, 64, 2)      # head dim 32


def test_mnist_transformer_routes_to_flash_and_matches_jax():
    """config_mnist_transformer.json cut to 2 layers: a 7 x 7 global level
    (49 tokens, 4 heads of 64) and class conditioning. Its attention goes
    through the flash wrapper (here its plain version), not K3's, and the
    denoiser matches the JAX model."""
    from k_diffusion_tpu_torch.ops.kernels import flash
    config = K.config.load_config(MNIST_TRANSFORMER)
    config["model"]["depths"] = [2]
    model = K.config.make_model(config)
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    sigma = np.float32([0.3, 6.0])
    classes = np.int32([3, 10])
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(sigma),
                                 class_cond=jnp.asarray(classes))["params"]
    params = randomized(params, 21)
    want = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **kw))(
        jnp.asarray(x), jnp.asarray(sigma), class_cond=jnp.asarray(classes))
    t_config = KT.config.load_config(MNIST_TRANSFORMER)
    t_config["model"]["depths"] = [2]
    port = KT.config.make_model(t_config, device="cpu").eval()
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    orig = (flash.reference, global_packed.reference)
    flash.reference = lambda *a, **k: calls.append("flash") or orig[0](*a, **k)
    global_packed.reference = lambda *a, **k: calls.append("k3") or orig[1](*a, **k)
    try:
        with torch.no_grad():
            got = KT.config.make_denoiser_wrapper(t_config)(port)(
                torch.from_numpy(x), torch.from_numpy(sigma),
                class_cond=torch.from_numpy(classes).long())
    finally:
        flash.reference, global_packed.reference = orig
    assert calls == ["flash", "flash"]
    close(got, want)


def test_import_without_jax():
    """The port, its entry points (train, sample, convert_for_inference,
    config_from_inference, make_grid) and its data, augmentation,
    checkpoint, GNS, optimizer, guidance, external, ODE, evaluation,
    Inception and remat-residual modules import, and the model runs, with
    jax, flax and optax unimportable, as on a machine that has none of
    them; nothing of the JAX package is imported."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "flax", "optax"):
            sys.modules[name] = None
        import torch
        import k_diffusion_tpu_torch as KT
        from k_diffusion_tpu_torch import (
            augmentation, checkpoint, config_from_inference,
            convert_for_inference, data, evaluation, external, gns,
            guidance, make_grid, ode, optim8bit, sample, train)
        from k_diffusion_tpu_torch.models import inception_v3
        from k_diffusion_tpu_torch.ops.kernels import residuals
        from k_diffusion_tpu_torch.utils import logging
        config = KT.config.load_config({str(CONFIG)!r})
        config["model"].update({OVERRIDES!r})
        model = KT.config.make_model(config, device="cpu")
        with torch.no_grad():
            out = model(torch.zeros(1, 64, 64, 3), torch.ones(1))
        assert out.shape == (1, 64, 64, 3)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax",
                                           "k_diffusion_tpu", "k_diffusion")
                    and sys.modules[m] is not None]
        """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


TEST_TINY = REPO / "configs" / "config_test_tiny.json"


def test_config_test_tiny_forward_matches_jax():
    """configs/config_test_tiny.json as it is: one global level of 8 x 8
    tokens, 2 heads of 32 (K1 and K13 at head dim 32 on the card; here
    their plain versions), class conditioning. The denoiser against JAX."""
    config = K.config.load_config(TEST_TINY)
    model = K.config.make_model(config)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    sigma = np.float32([0.2, 5.0])
    classes = np.int32([1, 4])
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(sigma),
                                 class_cond=jnp.asarray(classes))["params"]
    params = randomized(params, 23)
    want = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **kw))(
        jnp.asarray(x), jnp.asarray(sigma), class_cond=jnp.asarray(classes))
    port = KT.config.make_model(KT.config.load_config(TEST_TINY),
                                device="cpu").eval()
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(KT.config.load_config(TEST_TINY))(
            port)(torch.from_numpy(x), torch.from_numpy(sigma),
                  class_cond=torch.from_numpy(classes).long())
    close(got, want)
