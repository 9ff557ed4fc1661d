"""The port's augmentation (k_diffusion_tpu_torch/augmentation.py) against
the JAX package's on the CPU: the matrices and the 9-dim cond given the
draws JAX makes from its 12 key splits, the spline prefilter against JAX's
and scipy's, the affine warp at every order and the whole pipeline, on
seeded numpy images. Tolerances are stated beside each check."""

import math
from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from k_diffusion_tpu import augmentation as j_aug
from k_diffusion_tpu_torch import augmentation as t_aug

torch.set_num_threads(2)

# float32 on both sides
TOL = 1e-6
WARP_TOL = 1e-5


def close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (name, err)


def jax_draws(key, n):
    """The draws of n images as the JAX pipeline makes them from
    ``jax.random.split(key, n)``, each image's key split 12 ways."""
    def one(k):
        ks = jax.random.split(k, 12)
        u = lambda i: jax.random.uniform(ks[i], [])
        return {"a0": jax.random.randint(ks[0], [], 0, 2).astype(jnp.float32),
                "p1": u(1),
                "a1": jax.random.randint(ks[2], [], 0, 2).astype(jnp.float32),
                "p2": u(3), "a2": jax.random.normal(ks[4], []), "p3": u(5),
                "a3": u(6), "p4": u(7), "a4": u(8),
                "a5": jax.random.normal(ks[9], []), "p6": u(10),
                "a67": jax.random.normal(ks[11], [2])}
    keys = jax.random.split(key, n)
    draws = jax.vmap(one)(keys)
    return keys, {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_matrix(pipe, draws, i, height, width):
    """The JAX pipeline's composition for image i of the draws (its
    ``__call__`` composes the same list)."""
    d = {k: jnp.asarray(v[i].numpy()) for k, v in draws.items()}
    do = {j: (d[f"p{j}"] < pipe.a_prob).astype(jnp.float32)
          for j in (1, 2, 3, 4, 6)}
    a0, a1, a2 = d["a0"], d["a1"] * do[1], d["a2"] * do[2]
    a3 = (d["a3"] * 2 * math.pi - math.pi) * do[3]
    a4 = (d["a4"] * 2 * math.pi - math.pi) * do[4]
    a5 = d["a5"] * do[4]
    a6, a7 = d["a67"] * do[6]
    h, w = width, height
    mats = [j_aug.translate2d(h / 2 - 0.5, w / 2 - 0.5),
            j_aug.scale2d(1 - 2 * a0, 1.0), j_aug.scale2d(1.0, 1 - 2 * a1),
            j_aug.scale2d(pipe.a_scale ** a2, pipe.a_scale ** a2),
            j_aug.rotate2d(-a3), j_aug.rotate2d(a4),
            j_aug.scale2d(pipe.a_aniso ** a5, pipe.a_aniso ** -a5),
            j_aug.rotate2d(-a4),
            j_aug.translate2d(pipe.a_trans * w * a6, pipe.a_trans * h * a7),
            j_aug.translate2d(-h / 2 + 0.5, -w / 2 + 0.5)]
    return reduce(jnp.matmul, mats)


def images(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("a_prob", [0.12, 0.5, 1.0])
def test_matrices_and_cond_match_jax_given_its_draws(a_prob):
    """(16, 3, 3) matrices against JAX's composition and the cond against
    the JAX pipeline's own output, 1e-6 of the largest entry, on a
    non-square image."""
    jpipe = j_aug.KarrasAugmentationPipeline(a_prob)
    tpipe = t_aug.KarrasAugmentationPipeline(a_prob)
    keys, draws = jax_draws(jax.random.PRNGKey(int(a_prob * 100)), 16)
    mats, cond = tpipe.matrices(draws, 24, 40)
    x = jnp.zeros((24, 40, 3))
    want_cond = np.stack([np.asarray(jpipe(k, x)[2]) for k in keys])
    close(cond, want_cond, TOL, "cond")
    for i in range(16):
        close(mats[i], jax_matrix(jpipe, draws, i, 24, 40), TOL, f"mat {i}")
    if a_prob == 1.0:  # every augmentation acts
        assert (cond[:, 2:] != 0).all()


def test_transform_helpers_match_jax():
    t = np.float32([0.3, -1.7, 2.5])
    for j_fn, t_fn, args in (
            (j_aug.translate2d, t_aug.translate2d, (t[0], t[1])),
            (j_aug.scale2d, t_aug.scale2d, (t[2], t[0])),
            (j_aug.rotate2d, t_aug.rotate2d, (t[1],))):
        close(t_fn(*map(torch.tensor, args)), j_fn(*args), TOL, j_fn.__name__)
    ft = np.linspace(0, 1, 7, dtype=np.float32)
    close(t_aug.cubic_weights(torch.from_numpy(ft)),
          j_aug._cubic_weights(ft), TOL)
    close(t_aug.bspline3_weights(torch.from_numpy(ft)),
          j_aug._bspline3_weights(ft), TOL)
    i = np.arange(-20, 20)
    assert t_aug.reflect_index(torch.from_numpy(i), 7).tolist() == \
        np.asarray(j_aug._reflect_index(i, 7)).tolist()


@pytest.mark.parametrize("shape", [(16, 16, 3), (24, 40, 1), (64, 64, 3)])
def test_spline_prefilter_matches_jax_and_scipy(shape):
    """The DCT-matrix prefilter against JAX's DCT-domain one and against
    scipy's recursive spline filter (float64), 1e-5 of the largest
    value."""
    x = images(1, shape)
    got = t_aug.spline_prefilter(torch.from_numpy(x)[None])[0]
    close(got, j_aug.spline_prefilter(jnp.asarray(x)), WARP_TOL, "jax")
    want = np.stack([scipy.ndimage.spline_filter(
        x[..., c].astype(np.float64), order=3, mode="reflect")
        for c in range(shape[-1])], -1)
    close(got, want, WARP_TOL, "scipy")


@pytest.mark.parametrize("order", [0, 1, 3, "catmull-rom"])
def test_affine_warp_matches_jax(order):
    """Eight images, each under its own JAX-drawn matrix (every
    augmentation acting), against the JAX warp, 1e-5."""
    x = images(2, (8, 24, 32, 3))
    pipe = j_aug.KarrasAugmentationPipeline(1.0)
    _, draws = jax_draws(jax.random.PRNGKey(3), 8)
    mats = [jax_matrix(pipe, draws, i, 24, 32) for i in range(8)]
    got = t_aug.affine_warp(torch.from_numpy(x),
                            torch.from_numpy(np.stack(mats)), order)
    want = np.stack([j_aug.affine_warp(jnp.asarray(x[i]), mats[i], order)
                     for i in range(8)])
    close(got, want, WARP_TOL, str(order))


@pytest.mark.parametrize("a_prob,disable_all", [(0.5, False), (0.12, False),
                                                (0.5, True)])
def test_pipeline_matches_jax(a_prob, disable_all):
    """The whole pipeline, vmapped in JAX over the keys and batched here
    over the same draws: augmented, original and cond, 1e-5. JAX's eager
    vmap is the reference: on these white-noise images its jitted vmap
    differs from it by 2e-5 (the float32 roundings of the matrix product
    reach the coordinates, and prefiltered white noise is steep)."""
    x = images(4, (8, 32, 32, 3))
    jpipe = j_aug.KarrasAugmentationPipeline(a_prob, disable_all=disable_all)
    tpipe = t_aug.KarrasAugmentationPipeline(a_prob, disable_all=disable_all)
    keys, draws = jax_draws(jax.random.PRNGKey(5), 8)
    want = jax.vmap(jpipe)(keys, jnp.asarray(x))
    got = tpipe.apply(draws, torch.from_numpy(x))
    for g, w, name in zip(got, want, ("augmented", "original", "cond")):
        close(g, w, WARP_TOL, name)
    if disable_all:
        assert not got[2].any()


def test_draw_is_seeded_and_shaped():
    gen = lambda: torch.Generator().manual_seed(7)
    a = t_aug.KarrasAugmentationPipeline.draw(5, gen())
    b = t_aug.KarrasAugmentationPipeline.draw(5, gen())
    assert list(a) == ["a0", "p1", "a1", "p2", "a2", "p3", "a3", "p4", "a4",
                       "a5", "p6", "a67"]
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].shape == ((5, 2) if k == "a67" else (5,))
    assert set(a["a0"].tolist()) <= {0.0, 1.0}
    assert ((a["p1"] >= 0) & (a["p1"] < 1)).all()


def test_prefilter_matrix_is_built_once_per_size_and_device():
    """A training step reuses each axis's prefilter operator: the same
    tensor for the same (n, device), another for another n."""
    cpu = torch.device("cpu")
    a = t_aug.prefilter_matrix(24, cpu)
    assert t_aug.prefilter_matrix(24, cpu) is a
    assert t_aug.prefilter_matrix(32, cpu).shape == (32, 32)
    assert a.dtype == torch.float32 and a.device == cpu
