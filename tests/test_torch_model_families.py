"""The model surface the port added after the flagship HDiT and the U-Net
(k_diffusion_tpu_torch): shifted-window and cross attention, the
shifted-window and attention-free HDiT levels and its mapping conditioning,
the ViT (image_transformer_v1), the U-Net's cross-attention and variance
head, the DCT multiscale loss and DenoiserWithVariance, against the JAX
package on the CPU at small sizes, float32, with the JAX weights converted
by k_diffusion_tpu_torch.convert and inputs made with numpy from a seed."""

import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch.ops import attention as t_attention
from k_diffusion_tpu_torch.ops import rope as t_rope

torch.set_num_threads(2)

j_attention = importlib.import_module("k_diffusion_tpu.ops.attention")
j_rope = importlib.import_module("k_diffusion_tpu.ops.rope")
j_array = importlib.import_module("k_diffusion_tpu.utils.array")
j_itv1 = importlib.import_module("k_diffusion_tpu.models.image_transformer_v1")

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides: a plain op, and a whole model, loss or gradient
OP_TOL = 2e-5
TOL = 2e-4


def close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err,
                                                         np.abs(want).max())


def rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomized(params, seed):
    """Seeded noise into every kernel, bias and scale, the zero-initialised
    ones included (else the model ignores its blocks); the FourierFeatures
    bases kept."""
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        name = path[-1].key
        if name == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(p.shape[:-1]))
        if name == "bias":
            return 0.1 * noise
        return p * (1 + 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fill, params)


def build(config_dict, shape, seed=0, **init_kw):
    """(JAX config, JAX model, randomized params, port model with them)
    for a config dict, loaded by each package's own load_config."""
    j_config = K.config.load_config(config_dict)
    model = K.config.make_model(j_config)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros(shape), jnp.ones((shape[0],)),
        **init_kw)["params"]
    params = randomized(params, seed)
    t_config = KT.config.load_config(config_dict)
    port = KT.config.make_model(t_config, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(convert.state_dict_from_jax(to_numpy(params)))
    return j_config, model, params, t_config, port


def jnp_kw(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def torch_kw(kw):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}


def check_forward(setup, x, sigma, **kw):
    config, model, params, t_config, port = setup
    wrap = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **k: model.apply({"params": params}, x, s, **k))
    want = wrap(jnp.asarray(x), jnp.asarray(sigma), **jnp_kw(kw))
    port.eval()
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(t_config)(port)(
            torch.from_numpy(x), torch.from_numpy(sigma), **torch_kw(kw))
    close(got, want, name="forward")
    return got


def check_gradient(setup, reals, noise, sigma, **kw):
    """The mean loss and every parameter's gradient against jax.grad of
    the JAX loss (the FourierFeatures bases are port buffers)."""
    config, model, params, t_config, port = setup

    def loss_fn(p):
        inner = lambda x, s, **k: model.apply({"params": p}, x, s, **k)
        return K.config.make_denoiser_wrapper(config)(inner).loss(
            jnp.asarray(reals), jnp.asarray(noise), jnp.asarray(sigma),
            **jnp_kw(kw)).mean()

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = convert.flatten(to_numpy(want))
    port.train()
    names, tensors = zip(*port.named_parameters())
    loss = KT.config.make_denoiser_wrapper(t_config)(port).loss(
        torch.from_numpy(reals), torch.from_numpy(noise),
        torch.from_numpy(sigma), **torch_kw(kw)).mean()
    grads = torch.autograd.grad(loss, tensors)
    close(loss, want_loss, name="loss")
    assert set(names) == {n for n in want if not n.endswith(".basis")}
    for name, g in zip(names, grads):
        close(g, want[name], name=name)
    return dict(zip(names, grads))


# ---- shifted-window and cross attention -------------------------------------

@pytest.mark.parametrize("n_h,n_w,ws,shift", [(4, 4, 8, 4), (2, 3, 4, 2),
                                              (3, 2, 4, 0), (1, 1, 8, 4)])
def test_shifted_window_masks_equal_jax(n_h, n_w, ws, shift):
    got = t_attention.make_shifted_window_masks(n_h, n_w, ws, ws, shift)
    want = j_attention.make_shifted_window_masks(n_h, n_w, ws, ws, shift)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_window_partition_round_trip_matches_jax():
    x = rand(np.random.default_rng(0), 2, 8, 12, 3, 5)
    got = t_attention.window_partition(torch.from_numpy(x), 4)
    close(got, j_attention.window_partition(jnp.asarray(x), 4), 0)
    assert torch.equal(t_attention.window_unpartition(got, 4),
                       torch.from_numpy(x))


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("h,w", [(8, 12), (12, 4)])
def test_shifted_window_attention_matches_jax(h, w, shift):
    """h != w, at shift 0 and half the window (4), 2 heads of 8."""
    rng = np.random.default_rng(h + shift)
    q, k, v = (rand(rng, 2, h, w, 2, 8) for _ in range(3))
    got = t_attention.shifted_window_attention(
        *map(torch.from_numpy, (q, k, v)), 4, shift, scale=0.3)
    want = j_attention.shifted_window_attention(
        *map(jnp.asarray, (q, k, v)), 4, shift, scale=0.3)
    close(got, want, OP_TOL)


def test_cross_attention_matches_jax_with_a_fully_padded_row():
    """The additive -1e4 bias of JAX's CrossAttention2d: row 1's keys are
    all padding, so its bias is the same on every key and it attends as if
    none were padding, not to nothing (no NaN)."""
    rng = np.random.default_rng(1)
    q = rand(rng, 2, 10, 2, 8)
    k, v = rand(rng, 2, 7, 2, 8), rand(rng, 2, 7, 2, 8)
    padding = np.zeros((2, 7), bool)
    padding[0, 5:] = True
    padding[1, :] = True
    got = t_attention.cross_attention(*map(torch.from_numpy, (q, k, v)),
                                      torch.from_numpy(padding), 8 ** -0.5)
    bias = (jnp.asarray(padding)[:, None, None, :] * -10000.0).astype(jnp.float32)
    want = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                        bias=bias, scale=8 ** -0.5)
    assert torch.isfinite(got).all()
    close(got[:1], want[:1], OP_TOL)
    # row 1's logits sit near -1e4, where float32's spacing is 2^-10: two
    # roundings of one logit there differ by up to 1e-3
    unpadded = t_attention.global_attention(
        *(torch.from_numpy(t[1:]) for t in (q, k, v)), 8 ** -0.5)
    close(got[1:], want[1:], 2e-3)
    close(got[1:], unpadded, 2e-3)


# ---- the ViT's RoPE, the DCT and the frequency weights -----------------------

def test_interleaved_rope_matches_jax():
    rng = np.random.default_rng(2)
    t, freqs = rand(rng, 2, 3, 5, 16), rand(rng, 3, 5, 12)
    close(t_rope.rotate_half_interleaved(torch.from_numpy(t)),
          j_rope.rotate_half_interleaved(jnp.asarray(t)), 0)
    for start in (0, 4):
        close(t_rope.apply_rotary_emb_interleaved(
                  torch.from_numpy(freqs), torch.from_numpy(t), start, 0.5),
              j_rope.apply_rotary_emb_interleaved(
                  jnp.asarray(freqs), jnp.asarray(t), start, 0.5), OP_TOL)


def test_freqs_pixel_log_init_matches_jax():
    want = j_rope.freqs_pixel_log_init(10.0)(jax.random.PRNGKey(0), (12, 16))
    close(t_rope.freqs_pixel_log_init((12, 16), 10.0), want, OP_TOL)


@pytest.mark.parametrize("axes", [(1,), (1, 2), (0, 2, 3)])
def test_dct_and_idct_match_jax_and_round_trip(axes):
    x = rand(np.random.default_rng(3), 3, 8, 12, 5)
    got = KT.utils.dct(torch.from_numpy(x), axes)
    close(got, j_array.dct(jnp.asarray(x), axes), OP_TOL)
    close(KT.utils.idct(got, axes), j_array.idct(jnp.asarray(np.asarray(got)),
                                                 axes), OP_TOL)
    close(KT.utils.idct(got, axes), x, OP_TOL)


@pytest.mark.parametrize("scales", [0, 2, 3])
def test_freq_weights_match_jax(scales):
    close(KT.utils.freq_weight_nd((8, 12), scales),
          j_array.freq_weight_nd((8, 12), scales), OP_TOL)


# ---- the HDiT's shifted-window and attention-free levels, mapping_cond ------

SHIFTED = REPO / "configs" / "config_oxford_flowers_shifted_window.json"


def hdit_dict(**model):
    config = json.loads(SHIFTED.read_text())
    config["model"].update({"input_size": [32, 32], "patch_size": [2, 2],
                            "mapping_width": 64}, **model)
    return config


# down depth 3 (odd: the first layer of the up stack is shifted), 16 x 16
# tokens in 4 x 4 windows, a global mid level at 8 x 8
ODD = {"depths": [3, 2], "widths": [64, 128], "d_ffs": [128, 256],
       "self_attns": [{"type": "shifted-window", "d_head": 64,
                       "window_size": 4},
                      {"type": "global", "d_head": 64}],
       "dropout_rate": [0.0, 0.0]}
# a level with no attention between a shifted-window and a global one;
# with mapping conditioning
NONE = {"depths": [1, 2, 1], "widths": [64, 64, 128], "d_ffs": [128, 128, 256],
        "self_attns": [{"type": "shifted-window", "d_head": 64,
                        "window_size": 4},
                       {"type": "none"}, {"type": "global", "d_head": 64}],
        "dropout_rate": [0.0, 0.0, 0.0]}


@pytest.fixture(scope="module")
def odd():
    return build(hdit_dict(**ODD), (1, 32, 32, 3))


@pytest.fixture(scope="module")
def none_level():
    return build(hdit_dict(**NONE, mapping_cond_dim=5), (1, 32, 32, 3), 1,
                 mapping_cond=jnp.zeros((1, 5)))


def hdit_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rand(rng, 2, 32, 32, 3), rand(rng, 2, 32, 32, 3),
            np.float32([0.3, 4.0]))


def test_shifted_layers_alternate_as_in_jax(odd):
    """Layer i of a stack is shifted where i + offset is odd, the up
    stacks offset by the level's depth."""
    port = odd[4]
    got = {name: m.self_attn.shifted for name, m in port.named_children()
           if "_layer_" in name and hasattr(m, "self_attn")}
    assert got == {"down_0_layer_0": False, "down_0_layer_1": True,
                   "down_0_layer_2": False, "up_0_layer_0": True,
                   "up_0_layer_1": False, "up_0_layer_2": True,
                   "mid_layer_0": False, "mid_layer_1": True}


def test_shifted_window_hdit_forward_matches_jax(odd):
    reals, _, sigma = hdit_inputs(4)
    check_forward(odd, reals, sigma)


def test_shifted_window_hdit_gradient_matches_jax(odd):
    check_gradient(odd, *hdit_inputs(5))


def test_no_attention_level_with_mapping_cond_matches_jax(none_level):
    """Forward and gradient; the attention-free layers own no attention
    block, and mapping_cond_in_proj gets its gradient."""
    port = none_level[4]
    assert not hasattr(port.down_1_layer_0, "self_attn")
    mapping_cond = rand(np.random.default_rng(6), 2, 5)
    reals, noise, sigma = hdit_inputs(7)
    check_forward(none_level, reals, sigma, mapping_cond=mapping_cond)
    grads = check_gradient(none_level, reals, noise, sigma,
                           mapping_cond=mapping_cond)
    assert grads["mapping_cond_in_proj.kernel"].abs().max() > 0


def test_mapping_cond_is_required(none_level):
    port = none_level[4]
    with pytest.raises(ValueError, match="mapping_cond must be specified"):
        port(torch.zeros(1, 32, 32, 3), torch.ones(1))


@pytest.mark.parametrize("which", ["odd", "none_level"])
def test_condcache_equals_uncached(which, request):
    """A cached call equals the uncached one bit for bit; an attention-free
    layer takes its feed-forward scale only; mapping_cond is baked into
    the table, and beside cond_scales it raises."""
    _, _, _, _, port = request.getfixturevalue(which)
    port.eval()
    kw = ({"mapping_cond": torch.from_numpy(rand(np.random.default_rng(8), 2, 5))}
          if which == "none_level" else {})
    sigmas = torch.tensor([4.0, 1.0, 0.25])
    x = torch.from_numpy(rand(np.random.default_rng(9), 2, 32, 32, 3))
    cached = KT.condcache.ScheduledModel(port, sigmas, 2, **kw)
    with torch.no_grad():
        for s in sigmas:
            sigma = s.expand(2)
            assert torch.equal(cached(x, sigma), port(x, sigma, **kw))
    cached.check()
    if kw:
        with pytest.raises(ValueError, match="mapping_cond"), torch.no_grad():
            port(x, sigmas[:1].expand(2), cond_scales=cached.scales_table[0],
                 **kw)


# ---- the ViT -----------------------------------------------------------------

def vit_dict(**model):
    return {"model": {"type": "image_transformer_v1", "input_channels": 3,
                      "input_size": [16, 16], "patch_size": 2, "depth": 2,
                      "width": 128, "dropout_rate": 0.0, "sigma_data": 0.5,
                      "sigma_min": 1e-2, "sigma_max": 80.0, **model},
            "dataset": {"type": "imagefolder", "num_classes": 3}}


@pytest.fixture(scope="module")
def vit():
    return build(vit_dict(), (1, 16, 16, 3), 2,
                 class_cond=jnp.zeros((1,), jnp.int32))


def vit_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rand(rng, 2, 16, 16, 3), rand(rng, 2, 16, 16, 3),
            np.float32([0.3, 4.0]), {"class_cond": np.int32([0, 2])})


def test_vit_converter_is_a_rename(vit):
    _, _, params, _, port = vit
    flat = convert.flatten(to_numpy(params))
    state = port.state_dict()
    assert set(flat) == set(state)
    assert "block_1.self_attn.pos_emb.freqs_w" in state


def test_vit_forward_matches_jax(vit):
    reals, _, sigma, kw = vit_inputs(10)
    check_forward(vit, reals, sigma, **kw)


def test_vit_gradient_matches_jax(vit):
    """Every gradient, the learned RoPE frequencies and the QKNorm scales
    included (non-zero)."""
    reals, noise, sigma, kw = vit_inputs(11)
    grads = check_gradient(vit, reals, noise, sigma, **kw)
    for name in ("block_0.self_attn.pos_emb.freqs_h",
                 "block_1.self_attn.pos_emb.freqs_w",
                 "block_0.self_attn.qk_scale"):
        assert grads[name].abs().max() > 0, name


def test_vit_qk_scale_clamp_matches_jax(vit):
    """qk_scale above log 100 acts as log 100 (a minimum, the parameter
    untouched) and gets no gradient there, as in JAX."""
    config, model, params, t_config, _ = vit
    params = jax.tree_util.tree_map(np.asarray, params)
    params["block_0"]["self_attn"]["qk_scale"] = np.float32([6.0, 3.0])
    port = KT.config.make_model(t_config, device="cpu")
    port.load_state_dict(convert.state_dict_from_jax(params))
    setup = (config, model, params, t_config, port)
    reals, noise, sigma, kw = vit_inputs(12)
    check_forward(setup, reals, sigma, **kw)
    grads = check_gradient(setup, reals, noise, sigma, **kw)
    assert grads["block_0.self_attn.qk_scale"][0] == 0
    assert grads["block_0.self_attn.qk_scale"][1] != 0
    assert port.block_0.self_attn.qk_scale[0] == 6.0


def test_vit_param_group_labels_match_jax(vit):
    _, _, params, _, port = vit
    flat = convert.flatten(j_itv1.param_group_labels(to_numpy(params)))
    want = {k: v for k, v in flat.items() if not k.endswith(".basis")}
    assert KT.training._PARAM_LABELS["image_transformer_v1"](port) == want


def test_vit_dpmpp_2m_trajectory_matches_jax(vit):
    config, model, params, t_config, port = vit
    sigmas = np.array(K.sampling.get_sigmas_karras(6, 1e-2, 80.0, rho=7.0))
    x = rand(np.random.default_rng(13), 2, 16, 16, 3) * sigmas[0]
    classes = np.int32([1, 2])
    wrap = K.config.make_denoiser_wrapper(config)(
        lambda x, s, **kw: model.apply({"params": params}, x, s, **kw))
    want = K.sampling.sample_dpmpp_2m(wrap, jnp.asarray(x),
                                      jnp.asarray(sigmas),
                                      extra_args={"class_cond": classes})
    port.eval()
    with torch.no_grad():
        got = KT.sampling.sample_dpmpp_2m(
            KT.config.make_denoiser_wrapper(t_config)(port),
            torch.from_numpy(x), torch.from_numpy(sigmas),
            extra_args={"class_cond": torch.from_numpy(classes)})
    close(got, want)


def test_vit_inference_checkpoint_loads_through_its_metadata(vit, tmp_path):
    _, _, _, t_config, port = vit
    path = tmp_path / "vit.safetensors"
    KT.checkpoint.save_inference(path, port, t_config)
    config = KT.config.load_config(path)
    assert config == t_config
    model = KT.config.make_model(config, device="cpu")
    state, _ = KT.checkpoint.load_inference(path)
    model.load_state_dict(state)
    for (name, a), b in zip(port.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name


# ---- the U-Net's cross-attention and variance head, the loss wrappers -------

CIFAR10 = REPO / "configs" / "config_cifar10.json"


def unet_dict(**model):
    config = json.loads(CIFAR10.read_text())
    config["model"].update({
        "input_size": [16, 16], "channels": [64, 64, 128], "depths": [1, 1, 1],
        "self_attn_depths": [False, True, True],
        "cross_attn_depths": [False, True, True], "cross_cond_dim": 24,
        "has_variance": True, "patch_size": 2, "augment_wrapper": False,
        "dropout_rate": 0.0, **model})
    return config


@pytest.fixture(scope="module")
def unet():
    return build(unet_dict(), (1, 16, 16, 3), 3,
                 cross_cond=jnp.zeros((1, 5, 24)),
                 cross_cond_padding=jnp.zeros((1, 5), bool))


def cross_inputs(seed):
    """A 5-token sequence; row 0 padded past 3 tokens, row 1 wholly."""
    rng = np.random.default_rng(seed)
    padding = np.zeros((2, 5), bool)
    padding[0, 3:] = True
    padding[1] = True
    return {"cross_cond": rand(rng, 2, 5, 24), "cross_cond_padding": padding}


def test_unet_with_cross_attention_and_variance_builds_like_jax(unet):
    _, _, params, _, port = unet
    flat = convert.flatten(to_numpy(params))
    state = port.state_dict()
    assert set(flat) == set(state)
    for name in ("u_net_d_1.cross_0.norm_enc.scale",
                 "u_net_u_2.cross_0.kv_proj.bias"):
        assert name in state
    assert state["proj_out.kernel"].shape[-1] == 3 * 2 * 2 + 1
    assert port.u_net_d_1.cross_0.norm_enc.eps == 1e-6


def test_unet_cross_and_variance_forward_match_jax(unet):
    """The output (through the denoiser) and, with return_variance, the
    per-sample log variance."""
    config, model, params, t_config, port = unet
    rng = np.random.default_rng(14)
    x, sigma = rand(rng, 2, 16, 16, 3), np.float32([0.5, 3.0])
    kw = cross_inputs(15)
    out = check_forward(unet, x, sigma, **kw)
    assert torch.isfinite(out).all()
    want = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sigma),
                       return_variance=True, **jnp_kw(kw))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(sigma),
                   return_variance=True, **torch_kw(kw))
    assert len(got) == 2
    close(got[0], want[0])
    close(got[1], want[1])


def test_denoiser_with_variance_loss_and_gradient_match_jax(unet):
    config, _, _, t_config, port = unet
    den = KT.config.make_denoiser_wrapper(t_config)(port)
    assert type(den) is KT.denoiser.DenoiserWithVariance
    rng = np.random.default_rng(16)
    check_gradient(unet, rand(rng, 2, 16, 16, 3), rand(rng, 2, 16, 16, 3),
                   np.float32([0.4, 2.0]), **cross_inputs(17))


def test_simple_loss_with_variance_raises():
    with pytest.raises(ValueError, match="variance"):
        KT.config.make_denoiser_wrapper(KT.config.load_config(
            unet_dict(loss_config="simple")))


@pytest.mark.parametrize("scales", [2, 3])
def test_multiscale_loss_matches_jax(odd, scales):
    """Denoiser.loss with loss_scales > 1: the squared error in the DCT
    basis, weighted per frequency, per sample."""
    config, model, params, t_config, port = odd
    config = {**config, "model": {**config["model"], "loss_scales": scales}}
    t_config = {**t_config, "model": {**t_config["model"],
                                      "loss_scales": scales}}
    reals, noise, sigma = hdit_inputs(18)
    inner = lambda x, s, **kw: model.apply({"params": params}, x, s, **kw)
    want = K.config.make_denoiser_wrapper(config)(inner).loss(
        jnp.asarray(reals), jnp.asarray(noise), jnp.asarray(sigma))
    port.eval()
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(t_config)(port).loss(
            torch.from_numpy(reals), torch.from_numpy(noise),
            torch.from_numpy(sigma))
    close(got, want)


def test_train_step_passes_the_cross_sequence(unet):
    """make_train_step hands a batch's cross_cond and cross_cond_padding
    to the model: one step of the cross-attention and variance U-Net
    trains its key/value projections."""
    _, _, _, t_config, _ = unet
    t_config = {**t_config, "model": {
        **t_config["model"], "sigma_min": 1e-2, "sigma_max": 80.0,
        "sigma_sample_density": {"type": "lognormal", "mean": -1.2,
                                 "std": 1.2}}}
    model = KT.config.make_model(t_config, device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # the zero-init output head hides every block
        for name, p in model.named_parameters():
            if not p.any():
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(6))
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(t_config, model))
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(t_config),
        KT.config.make_sample_density(t_config["model"]))
    batch = {"reals": torch.from_numpy(rand(np.random.default_rng(19),
                                            1, 2, 16, 16, 3))}
    batch.update({k: torch.from_numpy(v[None])
                  for k, v in cross_inputs(20).items()})
    before = model.u_net_d_1.cross_0.kv_proj.kernel.detach().clone()
    metrics = step(state, batch, torch.Generator().manual_seed(21), 0.5)
    assert torch.isfinite(metrics["loss"])
    assert not torch.equal(model.u_net_d_1.cross_0.kv_proj.kernel, before)
