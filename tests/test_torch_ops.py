"""The port's plain modules (k_diffusion_tpu_torch: config, flops, denoiser,
sampling schedule, layers, ops) against the JAX package on the CPU, float32,
same inputs made with numpy from a seed."""

import importlib
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import layers as t_layers
from k_diffusion_tpu_torch import ops as t_ops
from k_diffusion_tpu_torch.models import flops as t_flops

torch.set_num_threads(2)

j_flops = importlib.import_module("k_diffusion_tpu.models.flops")
j_attention = importlib.import_module("k_diffusion_tpu.ops.attention")
j_rope = importlib.import_module("k_diffusion_tpu.ops.rope")

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides, the same operations summed in another order
TOL = 2e-5


def rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.json"))
# the ViT, which no shipped config uses: DiT-B/2's width and depth
VIT = {"model": {"type": "image_transformer_v1", "input_channels": 3,
                 "input_size": [32, 32], "patch_size": 2, "depth": 12,
                 "width": 768, "dropout_rate": 0.0},
       "dataset": {"type": "imagefolder"}}


@pytest.mark.parametrize("name", CONFIGS + ["vit"])
def test_load_config_matches_jax(name):
    source = VIT if name == "vit" else REPO / "configs" / name
    want = K.config.load_config(source)
    assert KT.config.load_config(source) == want


def test_round_to_power_of_two_matches_jax():
    for x in (100, 341.33, 682.67, 1000, 1365.3):
        assert (KT.config.round_to_power_of_two(x, 0.05)
                == K.config.round_to_power_of_two(x, 0.05))


@pytest.mark.parametrize("name", CONFIGS + ["vit"])
def test_every_config_builds_the_jax_tree(name):
    """make_model builds each shipped config (and the ViT) on the CPU with
    the JAX model's parameter names and shapes: its params and the
    FourierFeatures bases (buffers here)."""
    source = VIT if name == "vit" else REPO / "configs" / name
    config = K.config.load_config(source)
    m = config["model"]
    size = m["input_size"] if isinstance(m["input_size"], list) else [m["input_size"]] * 2
    kw = {}
    if config["dataset"]["num_classes"]:
        kw["class_cond"] = jnp.zeros((1,), jnp.int32)
    if m["type"] == "image_v1" and m["augment_wrapper"]:
        kw["mapping_cond"] = jnp.zeros((1, 9))
    shapes = jax.eval_shape(
        K.config.make_model(config).init, jax.random.PRNGKey(0),
        jnp.zeros((1, *size, m["input_channels"])), jnp.ones((1,)), **kw)
    want = {k: tuple(v.shape) for k, v in KT.convert.flatten(
        jax.tree_util.tree_map(lambda a: a, shapes["params"])).items()}
    model = KT.config.make_model(KT.config.load_config(source), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_analytic_flops_match_jax():
    for name in ("config_oxford_flowers.json", "config_512_hdit.json"):
        config = K.config.load_config(REPO / "configs" / name)
        for batch in (1, 8):
            assert (t_flops.analytic_transformer_flops(config, batch)
                    == j_flops.analytic_transformer_flops(config, batch))


@pytest.mark.parametrize("weighting", ["karras", "soft-min-snr", "snr"])
def test_denoiser_scalings_and_weightings_match_jax(weighting):
    sigma = np.float32([0.01, 0.4, 2.5, 80.0])
    want = K.Denoiser(lambda x, s: x, sigma_data=0.5, weighting=weighting)
    got = KT.Denoiser(lambda x, s: x, sigma_data=0.5, weighting=weighting)
    for g, w in zip(got.get_scalings(torch.from_numpy(sigma)),
                    want.get_scalings(jnp.asarray(sigma))):
        close(g, w)
    close(got.weighting(torch.from_numpy(sigma)),
          want.weighting(jnp.asarray(sigma)))
    x = rand(np.random.default_rng(0), 4, 8, 8, 3)
    close(got(torch.from_numpy(x), torch.from_numpy(sigma)),
          want(jnp.asarray(x), jnp.asarray(sigma)))


def test_get_sigmas_karras_matches_jax():
    close(KT.sampling.get_sigmas_karras(50, 0.01, 160.0, rho=7.0,
                                        device="cpu"),
          K.sampling.get_sigmas_karras(50, 0.01, 160.0, rho=7.0))


def test_sample_dpmpp_2m_matches_jax_gaussian_denoiser():
    """The exact posterior mean of N(0, 1) data as the model: the sampler's
    step algebra alone, 20 steps."""
    def gaussian(x, sigma):
        s = sigma.reshape(sigma.shape + (1,) * (x.ndim - 1))
        return x / (1 + s ** 2)

    x = rand(np.random.default_rng(1), 2, 8, 8, 3) * 80.0
    want = K.sampling.sample_dpmpp_2m(
        gaussian, jnp.asarray(x), K.sampling.get_sigmas_karras(20, 1e-2, 80.0))
    got = KT.sampling.sample_dpmpp_2m(
        gaussian, torch.from_numpy(x),
        KT.sampling.get_sigmas_karras(20, 1e-2, 80.0, device="cpu"))
    close(got, want)


def test_rms_norm_and_cosine_sim_match_jax():
    rng = np.random.default_rng(2)
    x, scale = rand(rng, 2, 4, 4, 64), 1 + rand(rng, 64, std=0.1)
    close(t_ops.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
          K.ops.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    q, k = rand(rng, 2, 16, 4, 64), rand(rng, 2, 16, 4, 64)
    attn_scale = 10 * (1 + rand(rng, 4, 1, std=0.1))
    for g, w in zip(
            t_ops.scale_for_cosine_sim(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(attn_scale)),
            K.ops.scale_for_cosine_sim(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(attn_scale))):
        close(g, w)


def test_rms_norm_rounds_the_factor_to_the_input_dtype():
    """bf16 input: the combined factor is cast to bf16 before the multiply,
    the JAX rounding point (the kernels round there too)."""
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(3))
    scale = torch.rand(64, generator=torch.Generator().manual_seed(4)) + 0.5
    xb = x.to(torch.bfloat16)
    factor = (scale * torch.rsqrt(xb.float().square().mean(-1, keepdim=True)
                                  + 1e-6)).to(torch.bfloat16)
    torch.testing.assert_close(t_ops.rms_norm(xb, scale), xb * factor,
                               rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(16, 16), (8, 12), (12, 8)])
def test_positions_and_rope_match_jax(h, w):
    pos_t, pos_j = t_ops.make_axial_pos(h, w), j_rope.make_axial_pos(h, w)
    close(pos_t, pos_j)
    close(t_ops.downscale_pos(pos_t), j_rope.downscale_pos(pos_j))
    assert j_rope.bounding_box(h, w) == t_ops.rope.bounding_box(h, w)
    freqs_t, freqs_j = (t_ops.axial_rope_freqs(32, 4),
                        j_rope.axial_rope_freqs(32, 4))
    close(freqs_t, freqs_j)
    theta_t = t_ops.axial_rope_theta(pos_t, freqs_t)
    theta_j = j_rope.axial_rope_theta(pos_j, freqs_j)
    close(theta_t, theta_j)
    x = rand(np.random.default_rng(5), 2, h, w, 4, 64)
    close(t_ops.apply_rotary_emb(torch.from_numpy(x), theta_t),
          j_rope.apply_rotary_emb(jnp.asarray(x), theta_j))


def test_fourier_features_match_jax_with_its_basis():
    ff = K.layers.FourierFeatures(9, 64)
    x = rand(np.random.default_rng(6), 3, 9)
    params = ff.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = t_layers.FourierFeatures(9, 64)
    port.load_state_dict({"basis": torch.from_numpy(
        np.array(params["params"]["basis"]))})
    close(port(torch.from_numpy(x)), ff.apply(params, jnp.asarray(x)))


def test_linear_geglu_matches_jax():
    rng = np.random.default_rng(7)
    x, w = rand(rng, 4, 32), rand(rng, 32, 96, std=32 ** -0.5)
    close(t_ops.linear_geglu(torch.from_numpy(x), torch.from_numpy(w)),
          K.ops.linear_geglu(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("n,ks", [(16, 7), (8, 7), (5, 7), (9, 4)])
def test_neighborhood_mask_matches_jax(n, ks):
    np.testing.assert_array_equal(t_ops.attention.neighborhood_mask_1d(n, ks),
                                  j_attention.neighborhood_mask_1d(n, ks))


def test_attention_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rand(rng, 2, 6, 10, 2, 64, std=0.2) for _ in range(3))
    close(t_ops.neighborhood_attention(*map(torch.from_numpy, (q, k, v)), 5),
          j_attention.neighborhood_attention(*map(jnp.asarray, (q, k, v)), 5))
    flat = [t.reshape(2, 60, 2, 64) for t in (q, k, v)]
    close(t_ops.global_attention(*map(torch.from_numpy, flat)),
          j_attention.global_attention(*map(jnp.asarray, flat)))


def test_append_dims():
    x = torch.ones(3)
    assert KT.utils.append_dims(x, 4).shape == (3, 1, 1, 1)
    with pytest.raises(ValueError):
        KT.utils.append_dims(torch.ones(2, 2), 1)
    assert math.isclose(float(KT.sampling.append_zero(x)[-1]), 0.0)
