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
from k_diffusion_tpu_torch.ops.kernels import (flash, fused_ffn,
                                               fused_mapping, fused_qkv,
                                               global_packed, na2d)

torch.set_num_threads(2)

j_qkv = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_qkv")
j_na = importlib.import_module("k_diffusion_tpu.ops.pallas.na2d")
j_gp = importlib.import_module("k_diffusion_tpu.ops.pallas.global_packed")
j_ffn = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_ffn")
j_map = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_mapping")
j_flash = importlib.import_module("k_diffusion_tpu.ops.pallas.flash")
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


def qkv_case(seed=0, b=1, h=32, w=32, d=128, e=64):
    rng = np.random.default_rng(seed)
    heads = d // e
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


@pytest.mark.parametrize("shape", [(1, 32, 32, 128), (2, 16, 8, 256),
                                   (1, 7, 7, 768), (2, 7, 7, 128)])
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


@pytest.mark.parametrize("b,s,heads,scale", [(2, 256, 2, 1.0),
                                             (1, 48, 1, 0.125),
                                             (2, 64, 4, 1.0)])
def test_global_packed_lse_matches_pallas_body(b, s, heads, scale):
    """K3's logsumexp, which K9 reads: the plain version against the Pallas
    forward's (b, channel blocks, s, heads a block) planes, one head per
    block at c = 64 and two at c = 128 and 256."""
    q, k, v = gp_case(9, b, s, heads)
    with pltpu.force_tpu_interpret_mode():
        _, lse = j_gp._gp_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              heads, scale, save_lse=True)
    want = np.moveaxis(np.asarray(lse), 3, 2).reshape(b, heads, s)
    got = global_packed.reference_lse(
        *map(torch.from_numpy, (q, k, v)), heads, scale)
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


@pytest.mark.parametrize("b,t,d,d_ff", [(1, 49, 768, 2304), (2, 49, 128, 384)])
def test_fused_ffn_matches_jax_dispatcher_at(b, t, d, d_ff):
    """config_512_hdit's 7 x 7-token d = 768 width and a 49-token map."""
    args = ffn_case(8, b, t, d, d_ff)
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


def stream_product(a, w):
    """a @ w as the streamed K5 forms it: one 16-row slab of w at a time,
    added in slab order into a float32 accumulator."""
    out = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(0, w.shape[0], fused_mapping.UNIT):
        out += a[:, k:k + fused_mapping.UNIT] @ w[k:k + fused_mapping.UNIT]
    return out


def cluster_mapping(emb, s_in, s_out, blocks, ranks, eps=1e-6, stream=False):
    """K5's cluster split (csrc/geglu.cu, mapping_kernel) in numpy float32:
    per strip of 16 batch rows (one cluster; rows past b zero), every block
    of the network has rank r of ``ranks`` take its hidden panels
    (``fused_mapping.rank_panels``): a | gate from W_up's value and gate
    columns of those panels, h = a gelu(gate), and the split-K partial h
    W_down[those rows] of the output; the partials are summed in rank order
    and added to the residual x. ``stream``: each product over 16-row slabs
    of the weights, as the streamed path adds its tiles."""
    mm = stream_product if stream else np.matmul
    from scipy.special import erf

    def rms(x, scale):
        ms = np.mean(x * x, -1, keepdims=True)
        return x * (scale / np.sqrt(ms + np.float32(eps)))

    b, d = emb.shape
    d_ff = blocks[0][2].shape[0]
    out = np.zeros_like(emb)
    for r0 in range(0, b, fused_mapping.ROWS):
        rows = min(fused_mapping.ROWS, b - r0)
        x = np.zeros((fused_mapping.ROWS, d), np.float32)
        x[:rows] = emb[r0:r0 + rows]
        x = rms(x, s_in)
        for ns, w_up, w_down in blocks:
            xn = rms(x, ns)
            total = np.zeros_like(x)
            for rank in range(ranks):
                first, end = fused_mapping.rank_panels(d_ff, ranks, rank)
                units = slice(fused_mapping.UNIT * first,
                              fused_mapping.UNIT * end)
                a = mm(xn, w_up[:, units])
                gate = mm(xn, w_up[:, d_ff:][:, units])
                h = a * (0.5 * gate * (1 + erf(gate / np.sqrt(2)))).astype(
                    np.float32)
                total = total + mm(h, w_down[units])
            x = x + total
        out[r0:r0 + rows] = rms(x, s_out)[:rows]
    return out


@pytest.mark.parametrize("b", [8, 33])
@pytest.mark.parametrize("ranks", fused_mapping.CLUSTER_SIZES)
def test_fused_mapping_cluster_split_matches_jax(ranks, b):
    """The flagship's mapping network (256 wide, d_ff 768, depth 2) split
    over a cluster of each size the kernel can choose, at batch 8 (one
    cluster, half its rows empty) and 33 (three clusters), against the
    JAX package's fused mapping network (its dispatcher on the CPU), both
    computing in float32."""
    emb, s_in, s_out, blocks = mapping_case(30 + ranks, b)
    want = j_map.fused_mapping(jnp.asarray(emb), jnp.asarray(s_in),
                               jnp.asarray(s_out), jax_blocks(blocks),
                               dtype=jnp.float32)
    close(cluster_mapping(emb, s_in, s_out, blocks, ranks), want, F32_TOL)


@pytest.mark.parametrize("d,d_ff,ranks", [(768, 2048, 16), (512, 1408, 12)])
def test_fused_mapping_streamed_split_matches_jax(d, d_ff, ranks):
    """The ViT's mapping networks (DiT-B/2's 768 / 2048, and 512 / 1408),
    whose layer shares stream through K5's ring: the split over ranks with
    every product formed slab by slab, against the JAX package's fused
    mapping network."""
    emb, s_in, s_out, blocks = mapping_case(40, 8, d, d_ff)
    want = j_map.fused_mapping(jnp.asarray(emb), jnp.asarray(s_in),
                               jnp.asarray(s_out), jax_blocks(blocks),
                               dtype=jnp.float32)
    close(cluster_mapping(emb, s_in, s_out, blocks, ranks, stream=True), want,
          F32_TOL)


def test_mapping_layout_keeps_the_hdit_resident_and_streams_the_vit():
    """The HDiT's 256 / 768 network keeps both layer shares resident at 16
    ranks (the path it ran before streaming existed); the ViT's widths
    stream, with at least the two
    stages the ring needs, for f32 and bf16 weights; a width whose fixed
    room leaves no two stages is refused."""
    assert fused_mapping.layout(256, 768, 2, 16, True) == ("resident", 2)
    for d, d_ff in ((512, 1408), (768, 2048)):
        for f32 in (True, False):
            kind, stages = fused_mapping.layout(d, d_ff, 2, 16, f32)
            assert kind == "stream" and 2 <= stages <= fused_mapping.MAX_STAGES
    assert fused_mapping.layout(768, 2048, 2, 1, True) == ("none", 0)


@pytest.mark.parametrize("ranks", fused_mapping.CLUSTER_SIZES)
def test_every_hidden_panel_lands_in_one_rank(ranks):
    """The ranks' panel ranges tile the hidden units: each panel in exactly
    one rank, none empty, at every cluster size and hidden width the kernel
    takes it at (d_ff / 16 panels >= ranks)."""
    for d_ff in range(64, 2049, 64):
        panels = d_ff // fused_mapping.UNIT
        if ranks > panels:
            continue
        owners = np.zeros(panels, int)
        for rank in range(ranks):
            first, end = fused_mapping.rank_panels(d_ff, ranks, rank)
            assert end > first
            owners[first:end] += 1
        np.testing.assert_array_equal(owners, 1)


@pytest.mark.parametrize("name", ["fused_qkv", "na2d", "global_packed",
                                  "fused_ffn", "fused_mapping", "flash",
                                  "na2d_heads", "na2d_proj"])
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
    elif name == "flash":
        flash.flash_attention(*map(torch.from_numpy, flash_case(12, 49)))
    elif name == "na2d_heads":
        na2d.na2d(*(torch.from_numpy(t).reshape(1, 8, 8, 2, 64)
                    for t in na_case(12, 1, 8, 8, 2)), 7)
    elif name == "na2d_proj":
        q, k, v = map(torch.from_numpy, na_case(12, 1, 8, 8, 2))
        na2d.na2d_packed_proj(q, k, v, v, torch.eye(128), 2, 7)
    else:
        port_mapping(*mapping_case(12, 2))
    assert kernels.launch_counts() == dict.fromkeys(kernels.COUNTERS, 0)


def test_unsupported_device_raises():
    """A tensor on neither CPU nor CUDA never falls back to the plain
    version."""
    q = torch.zeros((1, 8, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        na2d.na2d_packed(q, q, q, 2, 7)


# ---- backwards: the port's gradients (autograd through the plain versions,
# the path of CPU tensors) against jax.grad through the JAX dispatcher (its
# XLA VJP on the CPU) and against the Pallas backward bodies in interpret
# mode ------------------------------------------------------------------------

def port_grads(fn, inputs, cots):
    """Gradients of sum(<fn(*inputs), cots>) with respect to ``inputs``."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, leaves,
                               tuple(torch.from_numpy(c) for c in cots))


def jax_grads(fn, inputs, cots):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    cots = tuple(map(jnp.asarray, cots))
    return vjp(cots if len(cots) > 1 else cots[0])


def close_all(got, want, tol):
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        close(a, b_, tol)


def qkv_grad_case(seed, shape):
    """shape: (b, h, w, d), or (b, h, w, d, head dim) where it is not 64."""
    c = qkv_case(seed, *shape)
    rng = np.random.default_rng(seed + 100)
    cots = [rand(rng, *shape[:4]) for _ in range(3)]
    return c, (c["x"], c["ns"], c["w"], c["scale"]), cots


def port_qkv_grads(c, inputs, cots):
    pos = torch.from_numpy(c["pos"])
    return port_grads(lambda x, ns, w, s: fused_qkv.fused_qkv_prologue(
        x, pos, ns, w, s, c["heads"]), inputs, cots)


# every width K6 takes: the flagship's 128 and 256, config_512_hdit's 768
# (12 heads) and config_test_tiny's 64 (2 heads of 32)
@pytest.mark.parametrize("shape", [(1, 16, 16, 128), (2, 8, 16, 256),
                                   (1, 4, 4, 768), (2, 8, 8, 64, 32)])
def test_fused_qkv_grads_match_jax_dispatcher(shape):
    c, inputs, cots = qkv_grad_case(20, shape)
    pos = jnp.asarray(c["pos"])
    want = jax_grads(lambda x, ns, w, s: j_qkv.fused_qkv_prologue(
        x, pos, ns, w, s, c["heads"]), inputs, cots)
    close_all(port_qkv_grads(c, inputs, cots), want, F32_TOL)


def test_fused_qkv_grads_match_pallas_backward_body():
    """K6's Pallas body (dx, d norm_scale, d w_qkv, d attn_scale)."""
    c, inputs, cots = qkv_grad_case(21, (2, 16, 16, 128))
    with pltpu.force_tpu_interpret_mode():
        want = j_qkv._prologue_bwd_pallas(*map(jnp.asarray, inputs),
                                          *map(jnp.asarray, cots), c["heads"],
                                          1e-6, 1e-6)
    close_all(port_qkv_grads(c, inputs, cots), want, F32_TOL)


def na_grad_case(seed, b, h, w, heads):
    q, k, v = na_case(seed, b, h, w, heads)
    dout = rand(np.random.default_rng(seed + 100), b, h, w, heads * 64)
    return (q, k, v), [dout]


@pytest.mark.parametrize("b,h,w,heads,ks", [(1, 16, 24, 2, 7), (2, 16, 16, 4, 3)])
def test_na2d_grads_match_jax_dispatcher(b, h, w, heads, ks):
    inputs, cots = na_grad_case(22, b, h, w, heads)
    want = jax_grads(lambda q, k, v: j_na.na2d_packed(q, k, v, heads, ks),
                     inputs, cots)
    got = port_grads(lambda q, k, v: na2d.na2d_packed(q, k, v, heads, ks),
                     inputs, cots)
    close_all(got, want, F32_TOL)


def test_na2d_grads_match_pallas_backward_bodies():
    """The Pallas backward of na2d_packed, K7's body (dq and the per-tile
    dk/dv halo partials) then K8's (their overlap-add), from the residuals
    of the Pallas forward with lse."""
    inputs, cots = na_grad_case(23, 1, 32, 32, 2)
    q, k, v = map(jnp.asarray, inputs)
    with pltpu.force_tpu_interpret_mode():
        out, lse, k_halo, v_halo = j_na._na_packed_fwd(q, k, v, 7, 1.0, 16, 2,
                                                       save_lse=True)
        want = j_na._na_packed_bwd(7, 1.0, 16, 2,
                                   (q, k_halo, v_halo, out, lse),
                                   jnp.asarray(cots[0]))
    got = port_grads(lambda q, k, v: na2d.na2d_packed(q, k, v, 2, 7), inputs,
                     cots)
    close_all(got, want, F32_TOL)


def test_overlap_add_reference_sums_per_tile_partials():
    """K8's plain version. Per 8 x 8 query tile, the plain backward's dk/dv
    from that tile's queries alone lie inside the tile's 14 x 14 halo;
    laid out as K8 takes them (``packed_backward_partials_reference``),
    they overlap-add to the full dk/dv."""
    overlap_add_case(1, 16, 24, 2, 5)


@pytest.mark.parametrize("b,h,w,heads,ks", [(2, 24, 16, 1, 7), (1, 8, 16, 2, 1)])
def test_overlap_add_reference_sums_per_tile_partials_at(b, h, w, heads, ks):
    """The same at the largest window (clamped at every edge of a 24 x 16
    map) and at kernel size 1 (each tile's halo partial is the tile)."""
    overlap_add_case(b, h, w, heads, ks)


def overlap_add_case(b, h, w, heads, ks):
    (q, k, v), (dout,) = na_grad_case(30, b, h, w, heads)
    q, k, v, dout = map(torch.from_numpy, (q, k, v, dout))
    parts = na2d.packed_backward_partials_reference(q, k, v, dout, heads, ks)
    n_tiles = (h // na2d.TILE) * (w // na2d.TILE)
    assert all(p.shape == (b, heads, n_tiles, na2d.HALO_KEYS, 64)
               and p.dtype == torch.float32 for p in parts)
    got = na2d.overlap_add_reference(*parts, h, w, ks, dtype=torch.float32)
    _, dk, dv = na2d.reference_backward(q, k, v, dout, heads, ks)
    close_all(got, (dk, dv), F32_TOL)


def gp_grad_case(seed, b, s, heads):
    q, k, v = gp_case(seed, b, s, heads)
    return (q, k, v), [rand(np.random.default_rng(seed + 100), b, s, heads * 64)]


@pytest.mark.parametrize("b,s,heads", [(2, 64, 2), (1, 48, 8)])
def test_global_packed_grads_match_jax_dispatcher(b, s, heads):
    inputs, cots = gp_grad_case(24, b, s, heads)
    want = jax_grads(lambda q, k, v: j_gp.packed_global_attention(
        q, k, v, heads), inputs, cots)
    got = port_grads(lambda q, k, v: global_packed.packed_global_attention(
        q, k, v, heads), inputs, cots)
    close_all(got, want, F32_TOL)


def test_global_packed_grads_match_pallas_backward_body():
    """K9's Pallas body. The JAX package reaches it only on a TPU, so the
    pallas_call is built here as its custom_vjp backward builds it, from
    the residuals of the Pallas forward with lse."""
    import functools
    from jax.experimental import pallas as pl
    inputs, cots = gp_grad_case(25, 2, 128, 4)
    q, k, v = map(jnp.asarray, inputs)
    dout = jnp.asarray(cots[0])
    b, s, c = q.shape
    cblk, hb = 128, 2
    blk = pl.BlockSpec((1, s, cblk), lambda i, cb: (i, 0, cb))
    lse_blk = pl.BlockSpec((1, 1, s, hb), lambda i, cb: (i, cb, 0, 0))
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_gp._gp_fwd(q, k, v, 4, 1.0, save_lse=True)
        want = pl.pallas_call(
            functools.partial(j_gp._bwd_kernel, e=64, scale=1.0),
            grid=(b, c // cblk), in_specs=[blk] * 5 + [lse_blk],
            out_specs=[blk] * 3,
            out_shape=[jax.ShapeDtypeStruct(q.shape, q.dtype)] * 3,
        )(q, k, v, dout, out, lse)
    got = port_grads(lambda q, k, v: global_packed.packed_global_attention(
        q, k, v, 4), inputs, cots)
    close_all(got, want, F32_TOL)


def ffn_grad_case(seed, b=2, t=256, d=128, d_ff=384):
    args = ffn_case(seed, b, t, d, d_ff)
    return args, [rand(np.random.default_rng(seed + 100), b, t, d)]


# every width K10 takes: the flagship's 128 and 256, config_512_hdit's 512
# and config_test_tiny's 64
@pytest.mark.parametrize("b,t,d,d_ff", [(2, 256, 128, 384), (1, 64, 256, 768),
                                        (1, 16, 512, 1536), (2, 16, 64, 192)])
def test_fused_ffn_grads_match_jax_dispatcher(b, t, d, d_ff):
    inputs, cots = ffn_grad_case(26, b, t, d, d_ff)
    want = jax_grads(j_ffn.fused_geglu_ffn, inputs, cots)
    close_all(port_grads(fused_ffn.fused_geglu_ffn, inputs, cots), want,
              F32_TOL)


def test_fused_ffn_grads_match_pallas_backward_body():
    """K10's Pallas body (dx with the residual, d scale, d w_up, d w_down);
    its GELU is the erf polynomial."""
    inputs, cots = ffn_grad_case(27)
    with pltpu.force_tpu_interpret_mode():
        want = j_ffn._ffn_bwd_pallas(*map(jnp.asarray, inputs),
                                     jnp.asarray(cots[0]), 1e-6, 128)
    close_all(port_grads(fused_ffn.fused_geglu_ffn, inputs, cots), want,
              POLY_TOL)


def mapping_grad_case(seed, b=4, n=2):
    emb, s_in, s_out, blocks = mapping_case(seed, b, n=n)
    flat = [emb, s_in, s_out, *(t for blk in blocks for t in blk)]
    return flat, [rand(np.random.default_rng(seed + 100), *emb.shape)]


def port_mapping_grads(flat, cots):
    return port_grads(lambda emb, s_in, s_out, *ws: fused_mapping.fused_mapping(
        emb, s_in, s_out, [ws[i:i + 3] for i in range(0, len(ws), 3)],
        dtype=torch.float32), flat, cots)


def test_fused_mapping_grads_match_jax_dispatcher():
    flat, cots = mapping_grad_case(28)
    want = jax_grads(lambda emb, s_in, s_out, *ws: j_map.fused_mapping(
        emb, s_in, s_out, [ws[i:i + 3] for i in range(0, len(ws), 3)],
        dtype=jnp.float32), flat, cots)
    close_all(port_mapping_grads(flat, cots), want, F32_TOL)


def test_fused_mapping_grads_match_jax_custom_vjp():
    """The JAX kernel has no Pallas backward: its custom_vjp recomputes the
    reference, as the port's autograd Function does. Held against that
    custom_vjp, its forward run as the Pallas body."""
    flat, cots = mapping_grad_case(29)
    with pltpu.force_tpu_interpret_mode():
        want = jax_grads(lambda *f: j_map._fused_inner(list(f), 2, 1e-6,
                                                       jnp.float32),
                         flat, cots)
    close_all(port_mapping_grads(flat, cots), want, F32_TOL)


# ---- K13/K14 flash attention: the plain version and its gradients against
# the JAX dispatcher (jax.nn.dot_product_attention on the CPU) and against
# the Pallas bodies _flash_fwd / _flash_bwd in interpret mode, the latter on
# the (b * heads, s, e) packing the JAX dispatcher makes. The logits are
# not cosine-bounded here, as in the U-Net ---------------------------------

FLASH_CASES = [(s, scale) for s in (49, 64, 256) for scale in (1.0, 0.125)]


def flash_case(seed, s, b=2, heads=2):
    rng = np.random.default_rng(seed)
    return tuple(rand(rng, b, s, heads, 64, std=0.5) for _ in range(3))


def pack(t):
    """(b, s, heads, e) -> (b * heads, s, e), the JAX dispatcher's pack."""
    b, s, heads, e = t.shape
    return jnp.moveaxis(jnp.asarray(t), 2, 1).reshape(b * heads, s, e)


def unpack(t, b):
    n, s, e = t.shape
    return np.moveaxis(np.asarray(t).reshape(b, n // b, s, e), 1, 2)


@pytest.mark.parametrize("s,scale", FLASH_CASES)
def test_flash_matches_jax_dispatcher(s, scale):
    q, k, v = flash_case(40, s)
    want = j_flash.flash_attention(*map(jnp.asarray, (q, k, v)), scale=scale)
    close(flash.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=scale),
          want, F32_TOL)


@pytest.mark.parametrize("s,scale", FLASH_CASES)
def test_flash_matches_pallas_body(s, scale):
    """K13's Pallas body (tq = min(256, s), as the dispatcher picks), its
    output and its logsumexp (the plain ``reference_lse``, which K14
    reads)."""
    q, k, v = flash_case(41, s)
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_flash._flash_fwd(pack(q), pack(k), pack(v), scale,
                                      min(256, s))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    close(flash.flash_attention(tq, tk, tv, scale=scale), unpack(out, 2),
          F32_TOL)
    close(flash.reference_lse(tq, tk, tv, scale),
          np.asarray(lse).reshape(4, -1)[:, :s].reshape(2, 2, s), F32_TOL)


@pytest.mark.parametrize("s,scale", FLASH_CASES)
def test_flash_grads_match_jax_dispatcher(s, scale):
    inputs = flash_case(42, s)
    cots = [rand(np.random.default_rng(43), 2, s, 2, 64)]
    want = jax_grads(lambda q, k, v: j_flash.flash_attention(q, k, v,
                                                             scale=scale),
                     inputs, cots)
    got = port_grads(lambda q, k, v: flash.flash_attention(q, k, v, scale),
                     inputs, cots)
    close_all(got, want, F32_TOL)


@pytest.mark.parametrize("s", [49, 64, 256])
def test_flash_grads_match_pallas_backward_bodies(s):
    """K14's Pallas bodies (the dq kernel over query tiles, the dk/dv kernel
    over key tiles), from the residuals of the Pallas forward with lse, at
    the U-Net's scale 1/8."""
    inputs = flash_case(44, s)
    dout = rand(np.random.default_rng(45), 2, s, 2, 64)
    q, k, v = map(pack, inputs)
    tq = min(256, s)
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_flash._flash_fwd(q, k, v, 0.125, tq)
        want = j_flash._flash_bwd(0.125, tq, (q, k, v, out, lse), pack(dout))
    got = port_grads(lambda q, k, v: flash.flash_attention(q, k, v, 0.125),
                     inputs, [dout])
    close_all(got, [unpack(w, 2) for w in want], F32_TOL)
