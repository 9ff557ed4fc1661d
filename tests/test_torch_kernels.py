"""The port's kernel modules (k_diffusion_tpu_torch/ops/kernels) on the CPU,
where each wrapper runs its plain version: held against the JAX package's
public dispatcher (its XLA reference on the CPU) and against the Pallas
kernel body itself in interpret mode. Same float32 inputs on both sides,
made with numpy from a seed."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from k_diffusion_tpu_torch.ops import rope as t_rope
from k_diffusion_tpu_torch.ops.kernels import (fused_ffn, fused_mapping,
                                               fused_qkv, global_packed, na2d)

torch.set_num_threads(2)

j_qkv = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_qkv")
j_na = importlib.import_module("k_diffusion_tpu.ops.pallas.na2d")
j_gp = importlib.import_module("k_diffusion_tpu.ops.pallas.global_packed")
j_ffn = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_ffn")
j_map = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_mapping")
j_rope = importlib.import_module("k_diffusion_tpu.ops.rope")

# float32 on both sides, the same operations summed in another order
F32_TOL = 2e-5
# the Pallas GEGLU bodies take erf from a polynomial (erf_poly.py, max abs
# error 7.3e-5 in erf); through the down projection that is ~1e-4
POLY_TOL = 3e-4


def rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def unit_heads(rng, *shape, e=64):
    """q/k as the prologue makes them: norm sqrt(10) per head, so logits
    stay in [-10, 10] (the Pallas NA kernel needs bounded logits)."""
    t = rand(rng, *shape).reshape(*shape[:-1], -1, e)
    t = t / np.linalg.norm(t, axis=-1, keepdims=True) * np.sqrt(10.0)
    return t.reshape(shape).astype(np.float32)


def close(got, want, tol):
    """Max abs error within tol times want's max magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def qkv_case(seed=0, b=1, h=32, w=32, d=128):
    rng = np.random.default_rng(seed)
    heads = d // 64
    return dict(x=rand(rng, b, h, w, d),
                ns=(1 + rand(rng, b, d, std=0.1)),
                w=rand(rng, d, 3 * d, std=d ** -0.5),
                scale=10 * (1 + rand(rng, heads, std=0.1)),
                pos=np.array(j_rope.make_axial_pos(h, w)), heads=heads)


def port_qkv(c):
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in c.items()}
    return fused_qkv.fused_qkv_prologue(t["x"], t["pos"], t["ns"], t["w"],
                                        t["scale"], t["heads"])


@pytest.mark.parametrize("shape", [(1, 32, 32, 128), (2, 16, 8, 256)])
def test_fused_qkv_matches_jax_dispatcher(shape):
    c = qkv_case(1, *shape)
    want = j_qkv.fused_qkv_prologue(
        jnp.asarray(c["x"]), jnp.asarray(c["pos"]), jnp.asarray(c["ns"]),
        jnp.asarray(c["w"]), jnp.asarray(c["scale"]), c["heads"])
    for got, ref in zip(port_qkv(c), want):
        close(got, ref, F32_TOL)


def test_fused_qkv_matches_pallas_body():
    """The Pallas body builds its RoPE tables from make_axial_pos(h, w), the
    port from the passed pos: equal here, since pos is that grid."""
    c = qkv_case(2)
    with pltpu.force_tpu_interpret_mode():
        want = j_qkv._fused_fwd(
            jnp.asarray(c["x"]), jnp.asarray(c["ns"]), jnp.asarray(c["w"]),
            jnp.asarray(c["scale"]), c["heads"], 1e-6, 1e-6, 16)
    for got, ref in zip(port_qkv(c), want):
        close(got, ref, F32_TOL)


def test_rope_tables_follow_passed_positions():
    """The kernel's cos/sin tables come from the pos the model passes
    (here the downscaled grid of a merge), as the plain version's theta."""
    pos = t_rope.downscale_pos(t_rope.make_axial_pos(8, 8))
    cos, sin = fused_qkv.rope_tables(pos, 2, 64)
    theta = t_rope.axial_rope_theta(pos, t_rope.axial_rope_freqs(32, 2))
    assert cos.shape == (16, 2 * 16)
    np.testing.assert_array_equal(cos.numpy(), torch.cos(theta).reshape(16, -1))
    np.testing.assert_array_equal(sin.numpy(), torch.sin(theta).reshape(16, -1))


def na_case(seed, b, h, w, heads):
    rng = np.random.default_rng(seed)
    c = heads * 64
    return (unit_heads(rng, b, h, w, c), unit_heads(rng, b, h, w, c),
            rand(rng, b, h, w, c))


@pytest.mark.parametrize("b,h,w,heads,ks", [(1, 32, 32, 2, 7), (2, 16, 24, 4, 7),
                                            (1, 8, 8, 2, 7), (1, 16, 16, 2, 3)])
def test_na2d_matches_jax_dispatcher(b, h, w, heads, ks):
    q, k, v = na_case(3, b, h, w, heads)
    want = j_na.na2d_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            heads, ks)
    got = na2d.na2d_packed(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), heads, ks)
    close(got, want, F32_TOL)


def test_na2d_matches_pallas_body():
    q, k, v = na_case(4, 1, 32, 32, 2)
    with pltpu.force_tpu_interpret_mode():
        want, _ = j_na._na_packed_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), 7, 1.0, 16, 2)
    got = na2d.na2d_packed(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 2, 7)
    close(got, want, F32_TOL)


def test_na2d_reference_matches_jax():
    q, k, v = (t.reshape(1, 16, 16, 2, 64) for t in na_case(5, 1, 16, 16, 2))
    want = j_na.na2d_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 5)
    got = na2d.na2d_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 5)
    close(got, want, F32_TOL)


def gp_case(seed, b=2, s=256, heads=2):
    rng = np.random.default_rng(seed)
    c = heads * 64
    return (unit_heads(rng, b, s, c), unit_heads(rng, b, s, c),
            rand(rng, b, s, c))


@pytest.mark.parametrize("b,s,heads", [(2, 256, 2), (1, 64, 8)])
def test_global_packed_matches_jax_dispatcher(b, s, heads):
    q, k, v = gp_case(6, b, s, heads)
    want = j_gp.packed_global_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), heads)
    got = global_packed.packed_global_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads)
    close(got, want, F32_TOL)


def test_global_packed_matches_pallas_body():
    q, k, v = gp_case(7)
    with pltpu.force_tpu_interpret_mode():
        want, _ = j_gp._gp_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               2, 1.0)
    got = global_packed.packed_global_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 2)
    close(got, want, F32_TOL)


def ffn_case(seed, b=2, t=256, d=128, d_ff=384):
    rng = np.random.default_rng(seed)
    return (rand(rng, b, t, d), 1 + rand(rng, b, d, std=0.1),
            rand(rng, d, 2 * d_ff, std=d ** -0.5),
            rand(rng, d_ff, d, std=d_ff ** -0.5))


def test_fused_ffn_matches_jax_dispatcher():
    args = ffn_case(8)
    want = j_ffn.fused_geglu_ffn(*map(jnp.asarray, args))
    got = fused_ffn.fused_geglu_ffn(*map(torch.from_numpy, args))
    close(got, want, F32_TOL)


def test_fused_ffn_matches_pallas_body():
    args = ffn_case(9)
    with pltpu.force_tpu_interpret_mode():
        want = j_ffn._ffn_fwd(*map(jnp.asarray, args), 1e-6, 256)
    got = fused_ffn.fused_geglu_ffn(*map(torch.from_numpy, args))
    close(got, want, POLY_TOL)


def mapping_case(seed, b=4, d=256, d_ff=768, n=2):
    rng = np.random.default_rng(seed)
    blocks = [(1 + rand(rng, d, std=0.1), rand(rng, d, 2 * d_ff, std=d ** -0.5),
               rand(rng, d_ff, d, std=d_ff ** -0.5)) for _ in range(n)]
    return (rand(rng, b, d), 1 + rand(rng, d, std=0.1),
            1 + rand(rng, d, std=0.1), blocks)


def port_mapping(emb, in_scale, out_scale, blocks):
    t = torch.from_numpy
    return fused_mapping.fused_mapping(
        t(emb), t(in_scale), t(out_scale),
        [tuple(map(t, blk)) for blk in blocks], dtype=torch.float32)


def jax_blocks(blocks):
    return [tuple(map(jnp.asarray, blk)) for blk in blocks]


def test_fused_mapping_matches_jax_dispatcher():
    emb, s_in, s_out, blocks = mapping_case(10)
    want = j_map.fused_mapping(jnp.asarray(emb), jnp.asarray(s_in),
                               jnp.asarray(s_out), jax_blocks(blocks),
                               dtype=jnp.float32)
    close(port_mapping(emb, s_in, s_out, blocks), want, F32_TOL)


def test_fused_mapping_matches_pallas_body():
    emb, s_in, s_out, blocks = mapping_case(11)
    with pltpu.force_tpu_interpret_mode():
        want = j_map._fused_fwd(jnp.asarray(emb), jnp.asarray(s_in),
                                jnp.asarray(s_out), jax_blocks(blocks), 1e-6,
                                jnp.float32)
    close(port_mapping(emb, s_in, s_out, blocks), want, POLY_TOL)


@pytest.mark.parametrize("name", ["fused_qkv", "na2d", "global_packed",
                                  "fused_ffn", "fused_mapping"])
def test_cpu_tensors_take_plain_version_without_counting(name):
    """A CPU tensor runs the plain version: no build, no launch counted."""
    from k_diffusion_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    if name == "fused_qkv":
        port_qkv(qkv_case(12, 1, 8, 8, 128))
    elif name == "na2d":
        na2d.na2d_packed(*map(torch.from_numpy, na_case(12, 1, 8, 8, 2)), 2, 7)
    elif name == "global_packed":
        global_packed.packed_global_attention(
            *map(torch.from_numpy, gp_case(12, 1, 16, 2)), 2)
    elif name == "fused_ffn":
        fused_ffn.fused_geglu_ffn(*map(torch.from_numpy, ffn_case(12, 1, 16)))
    else:
        port_mapping(*mapping_case(12, 2))
    assert kernels.launch_counts() == dict.fromkeys(kernels.MODULES, 0)


def test_unsupported_device_raises():
    """A tensor on neither CPU nor CUDA never falls back to the plain
    version."""
    q = torch.zeros((1, 8, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        na2d.na2d_packed(q, q, q, 2, 7)
