"""The port's per-head neighborhood attention (``na2d``, kernels K11/K12),
its fused-epilogue op (``na2d_packed_proj``, K15), the HDiT's routing
between the packed and the per-head kernels, and the head-dim-32 plain
versions behind K1/K6 and K13/K14, on the CPU, where each wrapper runs its
plain version: held against the JAX package's dispatchers (their XLA
references on the CPU) and the Pallas bodies in interpret mode. Same
float32 inputs on both sides, made with numpy from a seed."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from k_diffusion_tpu_torch.models import image_transformer_v2 as t_itv2
from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d
from k_diffusion_tpu_torch.ops.kernels import flash, fused_qkv, na2d

torch.set_num_threads(2)

j_na = importlib.import_module("k_diffusion_tpu.ops.pallas.na2d")
j_qkv = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_qkv")
j_flash = importlib.import_module("k_diffusion_tpu.ops.pallas.flash")
j_rope = importlib.import_module("k_diffusion_tpu.ops.rope")

# float32 on both sides, the same operations summed in another order
F32_TOL = 2e-5
TILE = 8  # the Pallas bodies' query tile here: 16 x 16 maps of 2 x 2 tiles


def rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def unit_heads(rng, *shape):
    """q/k as the prologue makes them: norm sqrt(10) per head over the last
    axis, so logits stay in [-10, 10] (the Pallas NA bodies skip the max)."""
    t = rand(rng, *shape)
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)
            * np.sqrt(10.0)).astype(np.float32)


def close(got, want, tol=F32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def close_all(got, want, tol=F32_TOL):
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        close(a, b_, tol)


def port_grads(fn, inputs, cots):
    """Gradients of sum(<fn(*inputs), cots>) with respect to ``inputs``."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(cots))


def jax_grads(fn, inputs, cots):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    return vjp(jnp.asarray(cots))


def pack(t):
    """(b, h, w, heads, e) -> (b * heads, h, w, e), the JAX dispatcher's
    pack."""
    b, h, w, heads, e = t.shape
    return jnp.moveaxis(jnp.asarray(t), 3, 1).reshape(b * heads, h, w, e)


def unpack(t, b):
    n, h, w, e = t.shape
    return np.moveaxis(np.asarray(t).reshape(b, n // b, h, w, e), 1, 3)


def heads_case(seed, e, b=1, h=16, w=16, heads=2):
    rng = np.random.default_rng(seed)
    shape = (b, h, w, heads, e)
    return (unit_heads(rng, *shape), unit_heads(rng, *shape),
            rand(rng, *shape), rand(rng, *shape))


# ---- K11 / K12: the plain versions against na2d and the Pallas bodies -----

@pytest.mark.parametrize("e", na2d.HEAD_DIMS)
def test_na2d_matches_jax_dispatcher_and_pallas_body(e):
    """The plain version of K11 against the JAX dispatcher (masked SDPA on
    the CPU) and the interpret-mode Pallas body: its output and its
    per-query logsumexp (the body's log of the max-free sum)."""
    q, k, v, _ = heads_case(1, e)
    got = na2d.na2d(*map(torch.from_numpy, (q, k, v)), 7)
    close(got, j_na.na2d(*map(jnp.asarray, (q, k, v)), 7))
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_na._na_fwd(pack(q), pack(k), pack(v), 7, 1.0, TILE)
    close(got, unpack(out, 1))
    # lse (n, tiles_h, tiles_w, 64, 1) tilewise -> (n, h, w)
    lse = np.asarray(lse).reshape(2, 2, 2, TILE, TILE)
    lse = lse.transpose(0, 1, 3, 2, 4).reshape(2, 16, 16)
    logits = torch.einsum("bhwne,bkne->bnhwk", torch.from_numpy(q),
                          torch.from_numpy(k).reshape(1, 256, 2, e))
    mask = neighborhood_mask_2d(16, 16, 7, "cpu").reshape(16, 16, 256)
    want = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    close(want.reshape(2, 16, 16), lse)


@pytest.mark.parametrize("e", na2d.HEAD_DIMS)
def test_na2d_grads_match_jax_vjp_and_pallas_backward(e):
    """The plain backward of K12 (autograd through the plain version)
    against jax.vjp of na2d and the interpret-mode _na_bwd (its dq kernel
    over query tiles, its dk/dv kernel over key tiles' row slabs), from the
    residuals of the Pallas forward."""
    q, k, v, dout = heads_case(2, e)
    got = port_grads(lambda *t: na2d.na2d(*t, 7), (q, k, v), dout)
    close_all(got, jax_grads(lambda *t: j_na.na2d(*t, 7), (q, k, v), dout))
    qp, kp, vp = pack(q), pack(k), pack(v)
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_na._na_fwd(qp, kp, vp, 7, 1.0, TILE)
        want = j_na._na_bwd(7, 1.0, TILE, (qp, kp, vp, out, lse), pack(dout))
    close_all(got, [unpack(t, 1) for t in want])


def test_na2d_takes_strided_views_and_smaller_windows():
    """q, k, v as the unfused prologue leaves them (v a strided third of the
    projection) and kernel sizes 3 and 5: the same as contiguous copies,
    and as the JAX dispatcher."""
    rng = np.random.default_rng(3)
    qkv = rand(rng, 2, 16, 8, 3, 2, 32)
    q, k, v = (torch.from_numpy(qkv[:, :, :, i]) for i in range(3))
    strided = torch.from_numpy(qkv).unbind(3)
    assert not strided[2].is_contiguous()
    for ks in (3, 5):
        got = na2d.na2d(*strided, ks, scale=0.5)
        close(got, j_na.na2d(*map(jnp.asarray, (q, k, v)), ks, scale=0.5))
        close(got, na2d.na2d(q, k, v, ks, scale=0.5))


# ---- K15: the fused epilogue ------------------------------------------------

def proj_case(seed, b=1, h=16, w=16, c=128, e=64):
    rng = np.random.default_rng(seed)
    return (unit_heads(rng, b, h, w, c // e, e).reshape(b, h, w, c),
            unit_heads(rng, b, h, w, c // e, e).reshape(b, h, w, c),
            rand(rng, b, h, w, c), rand(rng, b, h, w, c),
            rand(rng, c, c, std=c ** -0.5), rand(rng, b, h, w, c))


@pytest.mark.parametrize("e", [64, 32])
def test_na2d_packed_proj_matches_jax_and_pallas_body(e):
    """K15's plain version, NA(q, k, v) @ w_out + skip, and its gradients
    against the JAX op (its XLA reference on the CPU) and against the JAX
    custom_vjp run with its forward as the interpret-mode Pallas body (its
    backward is the VJP of the reference, as the port's recomputes), at c
    = 128: 2 heads of 64, or 4 heads of 32, which the JAX dispatcher also
    sends to its Pallas body."""
    heads = 128 // e
    *inputs, dout = proj_case(4 if e == 64 else 5, e=e)
    fn = lambda q, k, v, s, w_: na2d.na2d_packed_proj(q, k, v, s, w_, heads,
                                                      7)
    got = fn(*map(torch.from_numpy, inputs))
    j_fn = lambda q, k, v, s, w_: j_na.na2d_packed_proj(q, k, v, s, w_,
                                                        heads, 7)
    close(got, j_fn(*map(jnp.asarray, inputs)))
    with pltpu.force_tpu_interpret_mode():
        close(got, j_na._na_packed_proj_fwd(*map(jnp.asarray, inputs), 7, 1.0,
                                            TILE, heads))
        pallas = lambda q, k, v, s, w_: j_na._na2d_packed_proj_inner(
            q, k, v, s, w_, 7, 1.0, TILE, heads)
        want_pallas = jax_grads(pallas, inputs, dout)
    grads = port_grads(fn, inputs, dout)
    close_all(grads, jax_grads(j_fn, inputs, dout))
    close_all(grads, want_pallas)


# ---- the HDiT's routing between K2 and K11 ----------------------------------

def test_packed_takes_matches_jax_predicate(monkeypatch):
    """``packed_takes`` is the JAX dispatcher's own test of whether
    na2d_packed keeps an NA level in the packed kernel, restricted to head
    dim 64 (the only one K2 takes): JAX's na2d_packed is driven here as on a
    TPU, with its two kernels replaced by recorders."""
    calls = []
    monkeypatch.setattr(j_na, "_use_pallas", lambda *a: True)
    monkeypatch.setattr(j_na, "na2d", lambda q, *a, **kw: calls.append(
        "per_head") or q)
    monkeypatch.setattr(j_na, "_na2d_packed_inner", lambda q, *a: calls.append(
        "packed") or q)
    for e in (16, 32, 64, 96, 128, 256):
        for c in (64, 128, 192, 256, 384, 512, 640, 768, 1024):
            if c % e:
                continue
            calls.clear()
            x = jnp.zeros((1, 8, 8, c))
            j_na.na2d_packed(x, x, x, c // e, 7)
            assert calls in (["packed"], ["per_head"])
            assert na2d.packed_takes(c, e) == (calls == ["packed"] and e == 64), \
                (c, e)


def routed_model(width, d_head=64):
    """A 32 x 32 HDiT: one NA level of ``width`` (8 x 8 tokens) and a global
    level, one layer each."""
    levels = (t_itv2.LevelSpec(1, width, 128, t_itv2.NeighborhoodAttentionSpec(
        d_head, 7)), t_itv2.LevelSpec(1, 128, 128, t_itv2.GlobalAttentionSpec(64)))
    return t_itv2.ImageTransformerDenoiserModelV2(
        levels, t_itv2.MappingSpec(1, 64, 128), 3, 3, (4, 4), device="cpu",
        generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("width,d_head,train_fusion,want", [
    (768, 64, "1", "na2d"),      # wider than 512: 12 heads of 64
    (192, 64, "1", "na2d"),      # not a multiple of 128: 3 heads of 64
    (128, 32, "1", "na2d"),      # head dim 32
    (128, 64, "1", "na2d_packed"),
    (128, 64, "0", "na2d")])     # the unfused training prologue
def test_hdit_routes_na_levels(monkeypatch, width, d_head, train_fusion, want):
    """The NA levels K2 does not take, and every NA level of the unfused
    training path, go through ``na2d`` (K11 on the card)."""
    monkeypatch.setenv("KDT_TRAIN_FUSION", train_fusion)
    calls = []
    for name in ("na2d", "na2d_packed"):
        orig = getattr(t_itv2, name)
        monkeypatch.setattr(t_itv2, name, lambda *a, _o=orig, _n=name, **kw:
                            calls.append(_n) or _o(*a, **kw))
    model = routed_model(width, d_head).train()
    with torch.no_grad():
        out = model(torch.randn(1, 32, 32, 3), torch.ones(1))
    assert out.shape == (1, 32, 32, 3)
    # down and up stacks of the NA level
    assert calls == [want, want]


# ---- head dim 32: the plain versions behind K1/K6 and K13/K14 ---------------

def qkv32_case(seed, b=2, h=8, w=8, d=64):
    rng = np.random.default_rng(seed)
    heads = d // 32
    return (rand(rng, b, h, w, d), np.array(j_rope.make_axial_pos(h, w)),
            1 + rand(rng, b, d, std=0.1), rand(rng, d, 3 * d, std=d ** -0.5),
            10 * (1 + rand(rng, heads, std=0.1)), heads)


def test_fused_qkv_head_dim_32_matches_jax():
    """K1's plain version at head dim 32 (2 heads of config_test_tiny's
    width 64) against the JAX dispatcher, and its gradients against
    jax.vjp; the RoPE tables are heads * 8 wide. The JAX dispatcher sends
    head dim 32 to its reference, never to the Pallas body (which it
    guards with e == 64, fused_qkv.py:451), so there is no body to hold the
    port's head dim 32 against."""
    x, pos, ns, w, scale, heads = qkv32_case(6)
    t_pos = torch.from_numpy(pos)
    t_x, t_ns, t_w, t_scale = map(torch.from_numpy, (x, ns, w, scale))
    got = fused_qkv.fused_qkv_prologue(t_x, t_pos, t_ns, t_w, t_scale, heads)
    want = j_qkv.fused_qkv_prologue(*map(jnp.asarray, (x, pos, ns, w, scale)),
                                    heads)
    close_all(got, want)
    cos, _ = fused_qkv.rope_tables(t_pos, heads, 32)
    assert cos.shape == (64, heads * 8)
    rng = np.random.default_rng(7)
    cots = [rand(rng, *x.shape) for _ in range(3)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, ns, w, scale)]
    out = fused_qkv.fused_qkv_prologue(leaves[0], t_pos, *leaves[1:], heads)
    grads = torch.autograd.grad(out, leaves, [torch.from_numpy(c) for c in cots])
    _, vjp = jax.vjp(lambda x_, ns_, w_, s_: j_qkv.fused_qkv_prologue(
        x_, jnp.asarray(pos), ns_, w_, s_, heads),
        *map(jnp.asarray, (x, ns, w, scale)))
    close_all(grads, vjp(tuple(map(jnp.asarray, cots))))


@pytest.mark.parametrize("s", [49, 64])
def test_flash_head_dim_32_matches_jax(s):
    """K13/K14's plain version at head dim 32 (config_test_tiny's 8 x 8
    global level is s = 64) against the JAX dispatcher and the
    interpret-mode Pallas bodies: output and gradients."""
    rng = np.random.default_rng(8)
    q, k, v, dout = (rand(rng, 2, s, 2, 32, std=0.5) for _ in range(4))
    got = flash.flash_attention(*map(torch.from_numpy, (q, k, v)))
    close(got, j_flash.flash_attention(*map(jnp.asarray, (q, k, v))))
    grads = port_grads(flash.flash_attention, (q, k, v), dout)
    close_all(grads, jax_grads(j_flash.flash_attention, (q, k, v), dout))

    def fpack(t):
        return jnp.moveaxis(jnp.asarray(t), 2, 1).reshape(4, s, 32)

    def funpack(t):
        return np.moveaxis(np.asarray(t).reshape(2, 2, s, 32), 1, 2)

    qp, kp, vp = fpack(q), fpack(k), fpack(v)
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_flash._flash_fwd(qp, kp, vp, 1.0, s)
        want = j_flash._flash_bwd(1.0, s, (qp, kp, vp, out, lse), fpack(dout))
    close(got, funpack(out))
    close_all(grads, [funpack(t) for t in want])
