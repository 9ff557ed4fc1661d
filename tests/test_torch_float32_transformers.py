"""Float32 compute on the card (``--mixed-precision no``) for the ViT and the
HDiT, on the CPU: the plain versions of the float32 kernels of the ViT and
of the HDiT's levels but the neighborhood kernels (K1/K6, K4/K10, K5,
K3/K9; tests/test_torch_float32_na.py has K2/K7 and K11/K12) against the JAX package in float32, forward and backward; the
arithmetic of the float32 kernels (csrc/fused_qkv_f32.cu, geglu_f32.cu:
the norm folded into the products, the per-panel epilogues, the RMS-norm
VJP from per-panel dot partials, the split-K weight gradients, the mapping
network's hidden units over a cluster's ranks) mirrored in torch against
the JAX VJP; each wrapper's dispatch by dtype with the library stood in for; the
float32 residual stash of K3; and 2-step float32 trainer runs of a
narrowed config_cifar10_transformer.json, of a small ViT and of a narrowed
config_oxford_flowers.json (a neighborhood level kept) against JAX's
float32 step. Same float32 inputs on both sides, made with numpy from a
seed."""

import ctypes
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

import k_diffusion_tpu as K
from k_diffusion_tpu import layout as j_layout
from k_diffusion_tpu.models import image_transformer_v2 as j_itv2
from k_diffusion_tpu_torch import checkpoint, convert
from k_diffusion_tpu_torch import train as t_train
from k_diffusion_tpu_torch import training as t_training
from k_diffusion_tpu_torch.ops import rope as t_rope
from k_diffusion_tpu_torch.ops.kernels import (_build, fused_ffn,
                                               fused_mapping, fused_qkv,
                                               global_packed, residuals)

torch.set_num_threads(2)

j_qkv = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_qkv")
j_gp = importlib.import_module("k_diffusion_tpu.ops.pallas.global_packed")
j_ffn = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_ffn")
j_map = importlib.import_module("k_diffusion_tpu.ops.pallas.fused_mapping")
j_rope = importlib.import_module("k_diffusion_tpu.ops.rope")

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides, the same operations summed in another order
F32_TOL = 2e-5
# the Pallas GEGLU bodies take erf from a polynomial (erf_poly.py)
POLY_TOL = 3e-4
# the train-step parity tests' bound and optimizer eps
# (tests/test_torch_train.py explains the eps)
TOL = 2e-4
STEP_EPS = 1e-4
EPS = 1e-6


def rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


def close_all(got, want, tol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, tol, str(i))


def jax_vjp(fn, inputs, cots):
    """(outputs, input gradients of sum(<fn(*inputs), cots>)) through JAX."""
    out, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    cots = tuple(map(jnp.asarray, cots))
    return out, vjp(cots if len(cots) > 1 else cots[0])


def torch_vjp(fn, inputs, cots):
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, leaves,
                                tuple(map(torch.from_numpy, cots)))
    return out, grads


# ---- the cases: the slice's widths at small batch ---------------------------

def qkv_case(seed, b, h, w, d, e):
    rng = np.random.default_rng(seed)
    heads = d // e
    inputs = (rand(rng, b, h, w, d), 1 + rand(rng, b, d, std=0.1),
              rand(rng, d, 3 * d, std=d ** -0.5),
              10 * (1 + rand(rng, heads, std=0.1)))
    cots = [rand(rng, b, h, w, d) for _ in range(3)]
    return inputs, cots, np.array(j_rope.make_axial_pos(h, w)), heads


def ffn_case(seed, b, t, d, d_ff):
    rng = np.random.default_rng(seed)
    inputs = (rand(rng, b, t, d), 1 + rand(rng, b, d, std=0.1),
              rand(rng, d, 2 * d_ff, std=d ** -0.5),
              rand(rng, d_ff, d, std=d_ff ** -0.5))
    return inputs, [rand(rng, b, t, d)]


def mapping_case(seed, b, d, d_ff, n=2):
    rng = np.random.default_rng(seed)
    flat = [rand(rng, b, d), 1 + rand(rng, d, std=0.1),
            1 + rand(rng, d, std=0.1)]
    for _ in range(n):
        flat += [1 + rand(rng, d, std=0.1), rand(rng, d, 2 * d_ff, std=d ** -0.5),
                 rand(rng, d_ff, d, std=d_ff ** -0.5)]
    return flat, [rand(rng, b, d)]


def gp_case(seed, b, s, heads):
    rng = np.random.default_rng(seed)
    return ([rand(rng, b, s, 64 * heads, std=0.3) for _ in range(3)],
            [rand(rng, b, s, 64 * heads)])


def blocks_of(flat):
    return [flat[i:i + 3] for i in range(3, len(flat), 3)]


# (name, case): the shifted-window config's levels 0 and 2 and
# config_test_tiny's head dim 32; K4 also on its float32 wide route, at
# config_512_hdit's 768 level and at 960; the HDiT's mapping network
# (resident in the bf16 kernel) and the ViT's at DiT-B/2's width (streamed
# there)
QKV_CASES = {"d128": (1, 8, 8, 128, 64), "d512": (1, 4, 4, 512, 64),
             "tiny_e32": (2, 4, 4, 64, 32)}
FFN_CASES = {"d128": (1, 64, 128, 384), "d512": (1, 16, 512, 1536),
             "tiny": (2, 16, 64, 192), "d768": (1, 16, 768, 2304),
             "d960": (1, 8, 960, 1920)}
MAPPING_CASES = {"hdit": (3, 256, 768), "vit": (2, 768, 2048)}


# ---- the plain versions in float32 against JAX -------------------------------

@pytest.mark.parametrize("case", list(QKV_CASES))
def test_fused_qkv_plain_version_matches_jax_in_float32(case):
    """fused_qkv_prologue's plain version (the CPU path, K1-f32's spec) and
    its gradients (K6-f32's) against the JAX dispatcher and its VJP."""
    inputs, cots, pos, heads = qkv_case(1, *QKV_CASES[case])
    t_pos = torch.from_numpy(pos)
    got, grads = torch_vjp(lambda x, ns, w, s: fused_qkv.fused_qkv_prologue(
        x, t_pos, ns, w, s, heads), inputs, cots)
    want, want_grads = jax_vjp(lambda x, ns, w, s: j_qkv.fused_qkv_prologue(
        x, jnp.asarray(pos), ns, w, s, heads), inputs, cots)
    close_all(got, want, F32_TOL)
    close_all(grads, want_grads, F32_TOL)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_fused_ffn_plain_version_matches_jax_in_float32(case):
    inputs, cots = ffn_case(2, *FFN_CASES[case])
    got, grads = torch_vjp(fused_ffn.fused_geglu_ffn, inputs, cots)
    want, want_grads = jax_vjp(j_ffn.fused_geglu_ffn, inputs, cots)
    close_all(got, (want,), F32_TOL)
    close_all(grads, want_grads, F32_TOL)
    with pltpu.force_tpu_interpret_mode():
        body = j_ffn._ffn_fwd(*map(jnp.asarray, inputs), EPS, 256)
    close(got[0], body, POLY_TOL)


@pytest.mark.parametrize("case", list(MAPPING_CASES))
def test_fused_mapping_plain_version_matches_jax_in_float32(case):
    """fused_mapping at compute dtype float32 (K5-f32's spec) and its
    gradients against the JAX dispatcher at float32, at the HDiT's and the
    ViT's widths."""
    flat, cots = mapping_case(3, *MAPPING_CASES[case])
    got, grads = torch_vjp(lambda e, si, so, *ws: fused_mapping.fused_mapping(
        e, si, so, blocks_of([e, si, so, *ws]), dtype=torch.float32), flat, cots)
    want, want_grads = jax_vjp(lambda e, si, so, *ws: j_map.fused_mapping(
        e, si, so, blocks_of([e, si, so, *ws]), dtype=jnp.float32), flat, cots)
    close_all(got, (want,), F32_TOL)
    close_all(grads, want_grads, F32_TOL)


@pytest.mark.parametrize("b,s,heads", [(2, 64, 2), (1, 256, 1)])
def test_packed_global_attention_plain_version_matches_jax_in_float32(
        b, s, heads):
    """K3-f32's and K9-f32's spec against the JAX dispatcher and VJP, and
    the logsumexp against the Pallas forward in interpret mode."""
    inputs, cots = gp_case(4, b, s, heads)
    got, grads = torch_vjp(lambda q, k, v: global_packed.packed_global_attention(
        q, k, v, heads), inputs, cots)
    want, want_grads = jax_vjp(lambda q, k, v: j_gp.packed_global_attention(
        q, k, v, heads), inputs, cots)
    close_all(got, (want,), F32_TOL)
    close_all(grads, want_grads, F32_TOL)
    with pltpu.force_tpu_interpret_mode():
        _, lse = j_gp._gp_fwd(*map(jnp.asarray, inputs), heads, 1.0,
                              save_lse=True)
    lse = np.moveaxis(np.asarray(lse), 3, 2).reshape(b, heads, s)
    close(global_packed.reference_lse(*map(torch.from_numpy, inputs), heads),
          lse, F32_TOL)


# ---- the float32 kernels' arithmetic, mirrored ---------------------------------

# the SMs of the card the mirrors size their split-K chunks for (an H100)
SMS = 132


def plain(t):
    return t


def chunked_atb(a, b, chunk):
    """a^T b as tw::dw_kernel forms it: per chunk of rows, the partials
    then summed in chunk order."""
    parts = [a[i:i + chunk].T @ b[i:i + chunk] for i in range(0, len(a), chunk)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def norm_vjp(dxn, x, ns_rows, r, dot, res=None):
    """tw::dxn_kernel's epilogue: dx = r dxn nscale - x (r^2 / d) dot (+ res)
    and the rows' d(nscale) terms dxn x r, with dot the per-row sum of dR R
    over the 64-column panels (sum(g1 x) = dot / r)."""
    d = x.shape[-1]
    dx = r * dxn * ns_rows - x * (r * r * dot / d)
    return (dx if res is None else dx + res), dxn * x * r


def qkv_f32_mirror(x, pos, ns, w, attn_scale, heads, gq, gk, gv, rnd=plain):
    """K1-f32's forward and K6-f32's three steps on (rows, d) as the kernels
    compute them, ``rnd`` applied to every product operand where the
    kernels round it to TF32: R = r (rnd(x nscale) rnd(W)) (both kernels'
    A fragments x nscale rounded as read, B the rounded copy of W^T), the
    cosine-sim scale and RoPE in the epilogue; the RoPE and cosine-sim VJPs on the
    panel's columns, dot partials per 64-column panel summed in panel
    order, the RMS-norm VJP after dxn = rnd(dR) rnd(W)^T, dW_qkv = rnd(xn)^T
    rnd(dR) over the wrapper's row chunks, d(attn_scale) from the sums of g
    qn."""
    b, h, w_, d = x.shape
    e, rows = d // heads, b * h * w_
    t = h * w_
    xf = x.reshape(rows, d)
    ns_rows = ns.repeat_interleave(t, 0)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS)
    w_r = rnd(w)
    raw = r * (rnd(xf * ns_rows) @ w_r)                 # (rows, 3d)
    theta = t_rope.axial_rope_theta(pos.reshape(t, 2), t_rope.axial_rope_freqs(
        e // 2, heads)).repeat(b, 1, 1)                 # (rows, heads, e / 4)
    cos, sin = torch.cos(theta), torch.sin(theta)
    quarter = e // 4

    def heads_of(m):
        return m.reshape(rows, heads, e)

    outs, dr_parts, das = [], [], []
    dot_panels = []
    for sec, g in enumerate((gq, gk, gv)):
        rs = heads_of(raw[:, sec * d:(sec + 1) * d])
        gs = heads_of(g.reshape(rows, d))
        if sec == 2:
            outs.append(rs.reshape(rows, d))
            dr = gs
        else:
            inv = torch.rsqrt(rs.square().sum(-1, keepdim=True) + EPS)
            rho = attn_scale[:, None].sqrt() * inv
            x1, x2 = rs[..., :quarter], rs[..., quarter:2 * quarter]
            y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                           rs[..., 2 * quarter:]], -1)
            outs.append((y * rho).reshape(rows, d))
            g1, g2 = gs[..., :quarter], gs[..., quarter:2 * quarter]
            gr = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin,
                            gs[..., 2 * quarter:]], -1)
            gsum = (gr * rs).sum(-1, keepdim=True)
            dr = rho * gr - rs * (rho * inv * inv * gsum)
            das.append((rho * gsum).sum((0, 2)))
        dr = dr.reshape(rows, d)
        dr_parts.append(dr)
        prod = dr * raw[:, sec * d:(sec + 1) * d]
        dot_panels += [prod[:, c:c + 64].sum(-1, keepdim=True)
                       for c in range(0, d, 64)]
    dot = dot_panels[0]
    for p in dot_panels[1:]:
        dot = dot + p
    dR = rnd(torch.cat(dr_parts, -1))                   # dR^T, written rounded
    dxn = dR @ w_r.T
    dx, dns_terms = norm_vjp(dxn, xf, ns_rows, r, dot)
    dns = dns_terms.reshape(b, t, d).sum(1)
    chunk = _build.f32_weight_chunks(rows, d, 3 * d, SMS)
    dw = chunked_atb(rnd(xf * ns_rows * r), dR, chunk)
    d_scale = (das[0] + das[1]) / (2 * attn_scale)
    shape = (b, h, w_, d)
    return ([o.reshape(shape) for o in outs],
            (dx.reshape(shape), dns, dw, d_scale))


@pytest.mark.parametrize("case", list(QKV_CASES))
def test_fused_qkv_f32_kernel_arithmetic_matches_jax(case):
    inputs, cots, pos, heads = qkv_case(5, *QKV_CASES[case])
    got, grads = qkv_f32_mirror(*map(torch.from_numpy, inputs[:1]),
                                torch.from_numpy(pos),
                                *map(torch.from_numpy, inputs[1:]), heads,
                                *map(torch.from_numpy, cots))
    want, want_grads = jax_vjp(lambda x, ns, w, s: j_qkv.fused_qkv_prologue(
        x, jnp.asarray(pos), ns, w, s, heads), inputs, cots)
    close_all(got, want, F32_TOL)
    close_all(grads, want_grads, F32_TOL)


def gelu_grad(g):
    return 0.5 * (1 + torch.erf(g * 2 ** -0.5)) + g * torch.exp(
        -0.5 * g * g) / (2 * torch.pi) ** 0.5


def ffn_f32_mirror(x, ns, w_up, w_down, g, rnd=plain, groups=1):
    """K4-f32 and K10-f32's three steps, as the kernels compute them,
    ``rnd`` applied to every product operand where the kernels round it to
    TF32. K4-f32 by its route (``fused_ffn.f32_route``): in one launch, h
    rounded once on chip and the hidden panels of ``f32_units`` units over
    a cluster of ``groups`` ranks (panels r, r + groups, ... of rank r),
    each rank's partial summed over its panels in order, the partials in
    rank order, then x; on the wide route (its two kernels) h rounded once
    into device memory and the down kernel with the residual. K10-f32: the up product and dh =
    rnd(g) rnd(W_down)^T, dot partials per 64-unit panel, dxn = rnd(dup)
    rnd(W_up)^T, dW_up = rnd(xn)^T rnd(dup) and dW_down = (rnd(g)^T
    rnd(h))^T over the wrapper's row chunks."""
    b, t, d = x.shape
    d_ff, rows = w_down.shape[0], b * t
    xf, gf = x.reshape(rows, d), g.reshape(rows, d)
    ns_rows = ns.repeat_interleave(t, 0)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS)
    up_r, down_r = rnd(w_up), rnd(w_down)
    up = r * (rnd(xf * ns_rows) @ up_r)
    a, gate = up[:, :d_ff], up[:, d_ff:]
    h = a * F.gelu(gate)
    if fused_ffn.f32_route(d) == "one":
        units = fused_ffn.f32_units(d)
        total = torch.zeros_like(xf)
        for rank in range(groups):
            part = torch.zeros_like(xf)
            for p in range(rank, d_ff // units, groups):
                cols = slice(p * units, (p + 1) * units)
                part = part + rnd(h[:, cols]) @ down_r[cols]
            total = total + part
        out = total + xf
    else:
        out = xf + rnd(h) @ down_r
    dh = rnd(gf) @ down_r.T
    da, dgate = dh * F.gelu(gate), dh * a * gelu_grad(gate)
    prod = da * a + dgate * gate
    dot = sum(prod[:, c:c + 64].sum(-1, keepdim=True)
              for c in range(0, d_ff, 64))
    dup = rnd(torch.cat([da, dgate], -1))              # dup^T, written rounded
    dx, dns_terms = norm_vjp(dup @ up_r.T, xf, ns_rows, r, dot, gf)
    dw_up = chunked_atb(rnd(xf * ns_rows * r), dup,
                        _build.f32_weight_chunks(rows, d, 2 * d_ff, SMS))
    dw_down = chunked_atb(rnd(gf), rnd(h),
                          _build.f32_weight_chunks(rows, d, d_ff, SMS)).T
    return out.reshape(b, t, d), (dx.reshape(b, t, d),
                                  dns_terms.reshape(b, t, d).sum(1), dw_up,
                                  dw_down)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_fused_ffn_f32_kernel_arithmetic_matches_jax(case):
    inputs, cots = ffn_case(6, *FFN_CASES[case])
    got, grads = ffn_f32_mirror(*map(torch.from_numpy, inputs),
                                torch.from_numpy(cots[0]))
    want, want_grads = jax_vjp(j_ffn.fused_geglu_ffn, inputs, cots)
    close(got, want, F32_TOL)
    close_all(grads, want_grads, F32_TOL)


@pytest.mark.parametrize("case,groups", [("d128", 4), ("d512", 3),
                                         ("tiny", 2)])
def test_fused_ffn_f32_cluster_partials_match_jax(case, groups):
    """K4-f32's one launch with its hidden panels over a cluster of
    ``groups`` ranks, the partials summed in rank order, against the JAX
    forward (the summation order is the kernel's, the sum the same)."""
    inputs, cots = ffn_case(18, *FFN_CASES[case])
    got, _ = ffn_f32_mirror(*map(torch.from_numpy, inputs),
                            torch.from_numpy(cots[0]), groups=groups)
    close(got, j_ffn.fused_geglu_ffn(*map(jnp.asarray, inputs)), F32_TOL)


def tf32_round(t):
    """cvt.rna.tf32.f32 on the float32 bits, in numpy: the low 13 mantissa
    bits rounded to nearest, ties away from zero (half an ulp added to the
    magnitude, the sign bit apart), then cleared."""
    bits = t.float().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(
        0xFFFFE000)).view(np.float32)).to(t.dtype)


def tf32_truncate(t):
    """A TF32 operand landed as it is: the low 13 mantissa bits ignored."""
    bits = t.float().numpy().view(np.uint32)
    return torch.from_numpy((bits & np.uint32(0xFFFFE000)).view(
        np.float32)).to(t.dtype)


def bf16_round(t):
    return t.to(torch.bfloat16).to(t.dtype)


def test_tf32_emulation_rounds_to_nearest_away():
    """The emulation of cvt.rna: exact TF32 values stay, the halfway
    point rounds away from zero in both signs, truncation drops it."""
    one, half = 1.0, 2.0 ** -11  # half a TF32 ulp at 1
    t = torch.tensor([one, one + half, -(one + half), one + half / 2,
                      one + 1.5 * half], dtype=torch.float64)
    want = [one, one + 2 * half, -(one + 2 * half), one, one + 2 * half]
    assert tf32_round(t).tolist() == want
    assert tf32_truncate(t).tolist() == [one, one, -one, one, one]


# the level-0 shapes of the flagship's float32 backwards cut to batch 1:
# K6 at 64 x 64 x 128 (2 heads of 64), K10 at 4096 x 128, d_ff 384
ROUNDING_CASES = {"fused_qkv": (1, 64, 64, 128, 64),
                  "fused_ffn": (1, 4096, 128, 384)}
# the bound phase 26 (b) holds the float32 kernels to on the card
TF32_SHARE = 0.25


@pytest.mark.parametrize("name", list(ROUNDING_CASES))
def test_float32_backward_rounding_against_float64(name, record_property):
    """K6-f32's and K10-f32's mirrors in float64 with every product operand
    rounded to TF32 as the kernels round it (cvt.rna), against the plain
    version in float64: each output's max abs error over its max|f64| is at
    most TF32_SHARE x that of the same mirror with its operands rounded to
    bf16, output by output (phase 26 (b)'s check on the card). The mirror
    with truncated operands (what the copy engine would land unrounded) is
    measured beside them and recorded, not held to the bound."""
    if name == "fused_qkv":
        inputs, cots, pos, heads = qkv_case(12, *ROUNDING_CASES[name])
        wide = [torch.from_numpy(a).double() for a in inputs]
        gs = [torch.from_numpy(c).double() for c in cots]
        t_pos = torch.from_numpy(pos)
        want = fused_qkv.reference_backward(wide[0], t_pos, *wide[1:], heads,
                                            *gs)
        run = lambda rnd: qkv_f32_mirror(wide[0], t_pos, *wide[1:], heads,
                                         *gs, rnd=rnd)[1]
    else:
        inputs, cots = ffn_case(13, *ROUNDING_CASES[name])
        wide = [torch.from_numpy(a).double() for a in inputs]
        g = torch.from_numpy(cots[0]).double()
        want = fused_ffn.reference_backward(*wide, g)
        run = lambda rnd: ffn_f32_mirror(*wide, g, rnd=rnd)[1]
    hold_rounding(name, run, want, record_property)


def hold_rounding(name, run, want, record_property):
    """``run(rnd)``'s outputs against ``want`` (float64), max abs error over
    max|f64| output by output, with every product operand rounded to TF32
    (cvt.rna), to bf16 and truncated: the TF32 errors at most TF32_SHARE x
    the bf16 ones; the truncated ones recorded beside them."""
    errs = {}
    for label, rnd in (("tf32", tf32_round), ("bf16", bf16_round),
                       ("truncated", tf32_truncate)):
        errs[label] = [((a - w).abs().max() / w.abs().max()).item()
                       for a, w in zip(run(rnd), want)]
    shares = [a / c for a, c in zip(errs["tf32"], errs["bf16"])]
    truncated = [a / c for a, c in zip(errs["truncated"], errs["bf16"])]
    record_property("tf32_over_bf16", shares)
    record_property("truncated_over_bf16", truncated)
    print(f"{name}: against float64 by output, tf32 / bf16 {shares}, "
          f"truncated / bf16 {truncated}")
    assert max(shares) <= TF32_SHARE, shares


@pytest.mark.parametrize("name", list(ROUNDING_CASES))
def test_float32_forward_rounding_against_float64(name, record_property):
    """K1-f32's q, k, v and K4-f32's out (its one launch, the panels over a
    cluster of 2) as their mirrors compute them in float64, every product
    operand rounded as the kernels round it (x nscale and the weights'
    copies, h once on chip), against the plain version in float64: each
    output's error at most TF32_SHARE x the bf16-rounded mirror's (phase 26
    (b)'s check on the card); the truncated variant's share recorded."""
    if name == "fused_qkv":
        inputs, cots, pos, heads = qkv_case(16, *ROUNDING_CASES[name])
        wide = [torch.from_numpy(a).double() for a in inputs]
        gs = [torch.from_numpy(c).double() for c in cots]
        t_pos = torch.from_numpy(pos)
        want = fused_qkv.reference(wide[0], t_pos, *wide[1:], heads)
        run = lambda rnd: qkv_f32_mirror(wide[0], t_pos, *wide[1:], heads,
                                         *gs, rnd=rnd)[0]
    else:
        inputs, cots = ffn_case(17, *ROUNDING_CASES[name])
        wide = [torch.from_numpy(a).double() for a in inputs]
        g = torch.from_numpy(cots[0]).double()
        want = (fused_ffn.reference(*wide),)
        run = lambda rnd: (ffn_f32_mirror(*wide, g, rnd=rnd, groups=2)[0],)
    hold_rounding(f"{name} forward", run, want, record_property)


def mapping_f32_mirror(emb, s_in, s_out, blocks, ranks=1, rnd=plain):
    """K5-f32 as mapping_f32_kernel computes it, ``rnd`` applied where it
    rounds to TF32: x = RMSNorm(emb, s_in); per block xn = rnd(RMSNorm(x,
    ns)) (rounded where it lands in shared memory), a | gate = xn rnd(W_up)
    (the weights rounded as read), h = rnd(a gelu(gate)) (rounded where it
    lands), each rank's partial h rnd(W_down) over its pairs of 32-unit
    panels (``f32_rank_pairs``), the partials summed in rank order, then
    added to x; the out norm."""
    def rms_rows(x, s):
        return x * (s * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS))

    x = rms_rows(emb, s_in)
    for ns, w_up, w_down in blocks:
        d_ff = w_down.shape[0]
        up = rnd(rms_rows(x, ns)) @ rnd(w_up)
        h = rnd(up[:, :d_ff] * F.gelu(up[:, d_ff:]))
        total = torch.zeros_like(x)
        for rank in range(ranks):
            first, end = fused_mapping.f32_rank_pairs(d_ff, ranks, rank)
            units = slice(fused_mapping.F32_PAIR * first,
                          fused_mapping.F32_PAIR * end)
            total = total + h[:, units] @ rnd(w_down)[units]
        x = x + total
    return rms_rows(x, s_out)


def jax_mapping(flat):
    return j_map.fused_mapping(*map(jnp.asarray, flat[:3]),
                               blocks_of(list(map(jnp.asarray, flat))),
                               dtype=jnp.float32)


@pytest.mark.parametrize("case", list(MAPPING_CASES))
def test_fused_mapping_f32_kernel_arithmetic_matches_jax(case):
    flat, _ = mapping_case(7, *MAPPING_CASES[case])
    t = [torch.from_numpy(a) for a in flat]
    got = mapping_f32_mirror(t[0], t[1], t[2], blocks_of(t))
    close(got, jax_mapping(flat), F32_TOL)


@pytest.mark.parametrize("case,ranks", [("hdit", 12), ("hdit", 5),
                                        ("vit", 16), ("vit", 3)])
def test_fused_mapping_f32_cluster_partials_match_jax(case, ranks):
    """K5-f32's hidden units over a cluster of ``ranks`` ranks (pairs of
    32-unit panels in ranges as even as they come), each rank's partial
    summed in rank order, against the JAX forward (the summation order is
    the kernel's, the sum the same)."""
    flat, _ = mapping_case(22, *MAPPING_CASES[case], n=3)
    t = [torch.from_numpy(a) for a in flat]
    got = mapping_f32_mirror(t[0], t[1], t[2], blocks_of(t), ranks=ranks)
    close(got, jax_mapping(flat), F32_TOL)
    d_ff = MAPPING_CASES[case][2]
    spans = [fused_mapping.f32_rank_pairs(d_ff, ranks, r) for r in range(ranks)]
    assert spans[0][0] == 0 and spans[-1][1] == d_ff // fused_mapping.F32_PAIR
    assert all(a[1] == b[0] and a[1] > a[0] for a, b in zip(spans, spans[1:]))


def test_float32_mapping_rounding_against_float64(record_property):
    """K5-f32's mirror in float64 at the HDiT's width over a cluster of 12,
    every product operand rounded as the kernel rounds it (xn and h where
    they land, the weights as read), against the plain version in float64:
    its error at most TF32_SHARE x the bf16-rounded mirror's (phase 26
    (b)'s check on the card); the truncated variant's share recorded."""
    flat, _ = mapping_case(23, 8, 256, 768)
    wide = [torch.from_numpy(a).double() for a in flat]
    want = (fused_mapping.reference(*wide[:3], blocks_of(wide),
                                    dtype=torch.float64),)
    hold_rounding("fused_mapping", lambda rnd: (mapping_f32_mirror(
        *wide[:3], blocks_of(wide), ranks=12, rnd=rnd),), want,
        record_property)


# ---- each wrapper's dispatch by dtype ------------------------------------------

@pytest.fixture
def fake_library(monkeypatch):
    """The kernel libraries stood in for: each launch records (entry, its
    arguments as Python values) and returns status 0; CPU tensors pass the
    CUDA check and the bf16 paths' occupancy queries answer a fixed split,
    so every wrapper's launch path runs here."""
    calls = []

    def launch(lib, entry, what, device, *args):
        calls.append((entry, [a.value if isinstance(a, ctypes.c_void_p)
                              else a for a in args]))

    monkeypatch.setattr(_build, "load", lambda name, **_: None)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(fused_qkv, "forward_split", lambda *a: (1, 1))
    monkeypatch.setattr(fused_ffn, "forward_split", lambda *a: (1, 1, 1))
    monkeypatch.setattr(fused_ffn, "forward_split_f32", lambda *a: 1)
    monkeypatch.setattr(fused_mapping, "cluster_size", lambda *a: 1)
    monkeypatch.setattr(fused_mapping, "f32_plan", lambda *a: (8, 1))
    for module in (fused_qkv, fused_ffn, fused_mapping, global_packed):
        for attr in ("launches", "bwd_launches", "launches_f32",
                     "bwd_launches_f32"):
            if hasattr(module, attr):
                monkeypatch.setattr(module, attr, 0)
    return calls


def counts(module):
    return tuple(getattr(module, a, None) for a in (
        "launches", "launches_f32", "bwd_launches", "bwd_launches_f32"))


def operands(name, dtype, seed=8):
    """Inputs of each wrapper in ``dtype`` at a small size."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, std=1.0: torch.from_numpy(rand(rng, *shape, std=std)).to(dtype)
    if name == "fused_qkv":
        return (t(2, 4, 4, 128), t_rope.make_axial_pos(4, 4), 1 + t(2, 128),
                torch.from_numpy(rand(rng, 128, 384)),
                torch.full((2,), 10.0), 2)
    if name == "fused_ffn":
        return (t(2, 16, 128), 1 + t(2, 128), torch.from_numpy(rand(rng, 128, 384)),
                torch.from_numpy(rand(rng, 192, 128)))
    if name == "fused_mapping":
        w = lambda *s: torch.from_numpy(rand(rng, *s)).to(
            torch.float32 if dtype == torch.float16 else dtype)
        return (t(3, 128), torch.ones(128), torch.ones(128),
                [(torch.ones(128), w(128, 384), w(192, 128))])
    return tuple(t(2, 64, 128) for _ in range(3)) + (2,)


ENTRIES = {  # name -> dtype -> (forward entry, backward entry)
    "fused_qkv": {torch.float32: ("kdt_fused_qkv_f32", "kdt_fused_qkv_bwd_f32"),
                  torch.bfloat16: ("kdt_fused_qkv", "kdt_fused_qkv_bwd")},
    "fused_ffn": {torch.float32: ("kdt_ffn_fwd_f32", "kdt_ffn_bwd_f32"),
                  torch.bfloat16: ("kdt_ffn_fwd", "kdt_ffn_bwd")},
    "global_packed": {
        torch.float32: ("kdt_global_packed_f32", "kdt_global_packed_bwd_f32"),
        torch.bfloat16: ("kdt_global_packed", "kdt_global_packed_bwd")},
    "fused_mapping": {torch.float32: ("kdt_mapping_f32", None),
                      torch.bfloat16: ("kdt_mapping", None)},
}


def forward_and_backward(name, args):
    """Runs the wrapper's forward entry and, where it has a backward
    kernel, the backward's, with cotangents of the outputs' shapes; returns
    the forward's outputs and the backward's gradients."""
    if name == "fused_qkv":
        out = fused_qkv.prologue_forward(*args)
        cots = [torch.zeros_like(o) for o in out]
        return out, fused_qkv.prologue_backward(*args, *cots)
    if name == "fused_ffn":
        out = fused_ffn.ffn_forward(*args)
        return (out,), fused_ffn.ffn_backward(*args, torch.zeros_like(out))
    if name == "fused_mapping":
        dtype = args[0].dtype
        return (fused_mapping.mapping_forward(*args, dtype=dtype),), ()
    out, lse = global_packed.packed_forward(*args, save_lse=True)
    return (out, lse), global_packed.packed_backward(
        *args[:3], out, lse, torch.zeros_like(out), args[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_wrappers_dispatch_by_dtype(fake_library, name, dtype):
    """float32 operands reach the float32 entry points and counters,
    bfloat16 the bf16 ones; the outputs and the activations' gradients are
    in the operands' dtype, the parameters' gradients float32."""
    module = {"fused_qkv": fused_qkv, "fused_ffn": fused_ffn,
              "fused_mapping": fused_mapping,
              "global_packed": global_packed}[name]
    args = operands(name, dtype)
    outs, grads = forward_and_backward(name, args)
    fwd, bwd = ENTRIES[name][dtype]
    assert [entry for entry, _ in fake_library] == [fwd] + ([bwd] if bwd else [])
    assert outs[0].dtype == dtype
    if name == "global_packed":
        assert outs[1].dtype == torch.float32
        assert all(g.dtype == dtype for g in grads)
    elif grads:
        assert grads[0].dtype == dtype and grads[2].dtype == torch.float32
    f32 = dtype == torch.float32
    want = (0 if f32 else 1, 1 if f32 else 0)
    got = counts(module)
    assert got[:2] == want
    if bwd:
        assert got[2:] == want


@pytest.mark.parametrize("name", list(ENTRIES))
@pytest.mark.parametrize("case", ["float16", "mixed"])
def test_wrappers_refuse_what_no_kernel_takes(fake_library, name, case):
    """float16 operands and operands of mixed dtypes raise ValueError by
    name; nothing launches."""
    if case == "float16":
        args = operands(name, torch.float16)
        match = "bfloat16 or float32"
        if name == "fused_mapping":
            call = lambda: fused_mapping.mapping_forward(
                *args, dtype=torch.float16)
        else:
            call = lambda: forward_and_backward(name, args)
    else:
        args = list(operands(name, torch.float32))
        match = "dtype"
        if name == "fused_mapping":
            call = lambda: fused_mapping.mapping_forward(
                args[0].bfloat16(), *args[1:], dtype=torch.float32)
        else:
            # the norm scale (K1, K4) or k (K3) in bfloat16
            at = 2 if name == "fused_qkv" else 1
            args[at] = args[at].bfloat16()
            call = lambda: forward_and_backward(name, args)
    with pytest.raises(ValueError, match=match):
        call()
    assert not fake_library


def test_float32_passes_the_widths_the_bf16_forms_refuse(fake_library):
    """The float32 forms take any d a multiple of 64: K1 past the bf16
    form's 768, K10 past its 576; the bf16 forms still refuse those widths
    by name before any launch."""
    rng = np.random.default_rng(9)
    for dtype in (torch.bfloat16, torch.float32):
        t = lambda *s: torch.from_numpy(rand(rng, *s)).to(dtype)
        x, ns = t(1, 2, 2, 832), 1 + t(1, 832)
        args = (x, t_rope.make_axial_pos(2, 2), ns,
                torch.from_numpy(rand(rng, 832, 3 * 832)),
                torch.full((13,), 10.0), 13)
        ffn = (t(1, 4, 640), 1 + t(1, 640),
               torch.from_numpy(rand(rng, 640, 1280)),
               torch.from_numpy(rand(rng, 640, 640)))
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="768"):
                fused_qkv.prologue_forward(*args)
            with pytest.raises(ValueError, match="576"):
                fused_ffn.ffn_backward(*ffn, ffn[0])
            assert not fake_library
        else:
            fused_qkv.prologue_forward(*args)
            fused_ffn.ffn_backward(*ffn, ffn[0])
            assert [e for e, _ in fake_library] == ["kdt_fused_qkv_f32",
                                                    "kdt_ffn_bwd_f32"]


# (b, t, d, d_ff) of K10-f32 and (b, h, w, d, heads) of K6-f32: ragged row
# tiles (49, 72 tokens: row counts not a multiple of 4), a width past the
# bf16 form's and head dim 32
F32_BWD_CASES = {"fused_ffn": [(2, 49, 128, 384), (1, 72, 640, 1280),
                               (3, 16, 64, 192)],
                 "fused_qkv": [(2, 7, 7, 128, 2), (1, 9, 8, 192, 3),
                               (3, 4, 4, 64, 2)]}


@pytest.mark.parametrize("name,case", [(n, c) for n, cases in
                                       F32_BWD_CASES.items() for c in cases])
def test_float32_backward_scratch_is_what_the_entry_point_is_told(
        fake_library, monkeypatch, name, case):
    """K10-f32's and K6-f32's scratch, as the wrappers allocate it, has the
    shapes and dtype that kdt_ffn_bwd_f32 and kdt_fused_qkv_bwd_f32 are
    told (csrc/geglu_f32.cu, fused_qkv_f32.cu): the rounded weight copies,
    the transposed intermediates at row pitch ld (at least the row count,
    a multiple of 4), the per-panel and per-tile partials of 128-row tiles
    and the split-K partials of chunks of a multiple of 32 rows."""
    seen = []

    def ptr(t):
        seen.append(t)
        return ctypes.c_void_p(t.data_ptr())

    monkeypatch.setattr(_build, "ptr", ptr)
    rng = np.random.default_rng(14)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    if name == "fused_ffn":
        b, tok, d, d_ff = case
        fused_ffn.ffn_backward(t(b, tok, d), 1 + t(b, d), t(d, 2 * d_ff),
                               t(d_ff, d), t(b, tok, d))
        (entry, args), = fake_library
        assert entry == "kdt_ffn_bwd_f32"
        names = ("w_upt", "w_up_r", "w_down_r", "ht", "dupt", "xn", "r",
                 "dot_part", "dns_part", "dw_part")
        scratch = dict(zip(names, seen[9:19]))
        images, tokens, tiles, d_, dff, ld, chunk_up, chunk_down = args[19:27]
        assert (images, tokens, d_, dff) == (b, tok, d, d_ff)
        rows = b * tok
        want = {"w_upt": (2 * d_ff, d), "w_up_r": (d, 2 * d_ff),
                "w_down_r": (d_ff, d), "ht": (d_ff, ld), "dupt": (2 * d_ff, ld),
                "xn": (rows, d), "r": (rows,), "dot_part": (d_ff // 64, rows),
                "dns_part": (b * tiles, d)}
        chunks = [chunk_up, chunk_down]
        parts = max(-(-rows // chunk_up) * 2 * d * d_ff,
                    -(-rows // chunk_down) * d * d_ff)
    else:
        b, h, w, d, heads = case
        fused_qkv.prologue_backward(
            t(b, h, w, d), t_rope.make_axial_pos(h, w), 1 + t(b, d),
            t(d, 3 * d), torch.full((heads,), 10.0), heads,
            *(t(b, h, w, d) for _ in range(3)))
        (entry, args), = fake_library
        assert entry == "kdt_fused_qkv_bwd_f32"
        names = ("wt", "w_r", "drt", "xn", "r", "dot_part", "das_part",
                 "dns_part", "dw_part")
        scratch = dict(zip(names, seen[13:22]))
        images, tokens, tiles, d_, n_heads, ld, chunk = args[22:29]
        assert (images, tokens, d_, n_heads) == (b, h * w, d, heads)
        rows = b * h * w
        want = {"wt": (3 * d, d), "w_r": (d, 3 * d), "drt": (3 * d, ld),
                "xn": (rows, d), "r": (rows,), "dot_part": (3 * d // 64, rows),
                "das_part": (b * tiles, 2 * heads), "dns_part": (b * tiles, d),
                "dw_part": (-(-rows // chunk), d, 3 * d)}
        chunks = [chunk]
        parts = -(-rows // chunk) * d * 3 * d
    assert tiles == -(-tokens // 128) == -(-tokens // _build.F32_ROWS)
    assert ld >= rows and ld % 4 == 0
    assert all(c > 0 and c % 32 == 0 for c in chunks)
    for key, tensor in scratch.items():
        assert tensor.dtype == torch.float32 and tensor.is_contiguous(), key
        if key in want:
            assert tuple(tensor.shape) == want[key], key
    assert scratch["dw_part"].numel() >= parts


@pytest.mark.parametrize("name,case", [
    ("fused_ffn", (1, 16, 96, 192)), ("fused_ffn", (1, 16, 128, 96)),
    ("fused_qkv", (1, 4, 4, 96, 3)), ("fused_qkv", (1, 4, 4, 128, 1)),
    ("fused_qkv", (1, 4, 4, 128, 8))])
def test_float32_backwards_refuse_before_any_launch(fake_library, name, case):
    """K10-f32 refuses d or d_ff not a multiple of 64, K6-f32 a d not a
    multiple of 64 and head dims other than 32 and 64 (128, 16), with
    ValueError before anything launches."""
    rng = np.random.default_rng(15)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    if name == "fused_ffn":
        b, tok, d, d_ff = case
        call = lambda: fused_ffn.ffn_backward(
            t(b, tok, d), 1 + t(b, d), t(d, 2 * d_ff), t(d_ff, d),
            t(b, tok, d))
    else:
        b, h, w, d, heads = case
        call = lambda: fused_qkv.prologue_backward(
            t(b, h, w, d), t_rope.make_axial_pos(h, w), 1 + t(b, d),
            t(d, 3 * d), torch.full((heads,), 10.0), heads,
            *(t(b, h, w, d) for _ in range(3)))
    with pytest.raises(ValueError):
        call()
    assert not fake_library


def test_float32_forwards_read_a_strided_scale_row(fake_library):
    """K1's and K4's float32 forms take their scale as a (b, d) column
    block of a wider matrix (a condcache row), read in place through its
    row stride, as the bf16 forms do: the launch gets the block's pointer
    and the row stride; a stride that is not a multiple of 4 floats (16
    bytes) is refused by name."""
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    table = t(2, 3 * 128 + 64)
    scale = table[:, 64:192]
    x = t(2, 4, 4, 128)
    fused_qkv.prologue_forward(x, t_rope.make_axial_pos(4, 4), scale,
                               t(128, 384), torch.full((2,), 10.0), 2)
    fused_ffn.ffn_forward(x.reshape(2, 16, 128), scale, t(128, 384),
                          t(192, 128))
    (qkv, args), (ffn, ffn_args) = fake_library
    assert (qkv, ffn) == ("kdt_fused_qkv_f32", "kdt_ffn_fwd_f32")
    assert args[1] == ffn_args[1] == scale.data_ptr()
    assert args[14] == ffn_args[12] == 3 * 128 + 64
    odd = t(2, 3 * 128 + 2)[:, :128]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fused_ffn.ffn_forward(x.reshape(2, 16, 128), odd, t(128, 384),
                              t(192, 128))


# (b, t, d, d_ff) of K4-f32's forward: ragged row tiles (49 tokens) and
# every width it takes in one launch, then its wide route at
# config_512_hdit's 768 and at 960, past the bf16 form's 896
F32_FWD_FFN_CASES = [(2, 49, 64, 192), (1, 16, 128, 384), (2, 49, 256, 768),
                     (1, 16, 512, 1536), (1, 4, 768, 2304), (1, 4, 960, 1920)]


@pytest.mark.parametrize("case", F32_FWD_FFN_CASES)
def test_float32_ffn_forward_routes_by_width(fake_library, monkeypatch,
                                             case):
    """K4-f32's forward is routed by width before any launch: one launch of
    kdt_ffn_fwd_f32 at d = 64, 128, 256 and 512, told the rounded W_up^T (2
    d_ff, d) and W_down^T (d, d_ff) float32 scratch, no h; past them
    kdt_ffn_fwd_f32_wide, with the same weight copies and h (rows, d_ff)
    float32. One launch counted either way (csrc/geglu_f32.cu's
    contracts)."""
    seen = []

    def ptr(t):
        seen.append(t)
        return ctypes.c_void_p(t.data_ptr())

    monkeypatch.setattr(_build, "ptr", ptr)
    rng = np.random.default_rng(19)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    b, tok, d, d_ff = case
    out = fused_ffn.ffn_forward(t(b, tok, d), 1 + t(b, d), t(d, 2 * d_ff),
                                t(d_ff, d))
    (entry, args), = fake_library
    rows = b * tok
    if d in (64, 128, 256, 512):
        assert entry == "kdt_ffn_fwd_f32"
        scratch, want = seen[5:7], [(2 * d_ff, d), (d, d_ff)]
        assert args[7:12] == [b, tok, d, d_ff, 1] and args[15] is None
    else:
        assert entry == "kdt_ffn_fwd_f32_wide"
        scratch, want = seen[5:8], [(2 * d_ff, d), (d, d_ff), (rows, d_ff)]
        assert args[8:13] == [b, tok, d, d_ff, d]
    assert len(seen) == 5 + len(want)
    for tensor, shape in zip(scratch, want):
        assert tensor.dtype == torch.float32 and tensor.is_contiguous()
        assert tuple(tensor.shape) == shape
    assert out.shape == (b, tok, d) and counts(fused_ffn)[:2] == (0, 1)


# K5-f32's plan, as the module defines it (the fake library stands in a
# fixed one)
FUSED_F32_PLAN = fused_mapping.f32_plan
# (b, d, d_ff, n) of K5-f32 -> (strip rows, ranks) its plan takes on a
# card that places every cluster: the flagship's at batch 8 (12 ranks of
# one pair), the ViT's at 64 (a strip of 64 leaves no ring stage at d
# 768: two strips of 32), a batch of 3 and one of 20, 130 rows at d 256 (3
# strips of 64) and the widest width it takes at d_ff 8 192
F32_MAPPING_PLANS = {(8, 256, 768, 2): (8, 12), (64, 768, 2048, 2): (32, 16),
                     (3, 128, 192, 1): (8, 3), (20, 256, 768, 3): (32, 12),
                     (130, 256, 768, 2): (64, 12),
                     (2, 4480, 8192, 1): (8, 16)}


@pytest.mark.parametrize("case", list(F32_MAPPING_PLANS))
def test_float32_mapping_is_one_launch(fake_library, monkeypatch, case):
    """K5-f32 is one launch of kdt_mapping_f32 (csrc/geglu_f32.cu's
    contract): emb, the scales and out by pointer, the model's float32
    weights by pointer as they lie (no copy, no scratch), the batch, the
    widths and depth, the strip rows and ranks of its plan (``f32_plan``,
    the narrowest strip that holds the batch, narrowed while its shared
    memory leaves fewer than two ring stages, the most ranks up to the
    pairs of panels), no stamps; one launch counted."""
    seen = []

    def ptr(t):
        seen.append(t)
        return ctypes.c_void_p(t.data_ptr())

    monkeypatch.setattr(_build, "ptr", ptr)
    monkeypatch.setattr(fused_mapping, "f32_plan", FUSED_F32_PLAN)
    monkeypatch.setattr(fused_mapping, "_query_f32", lambda *a: 1)
    FUSED_F32_PLAN.cache_clear()
    b, d, d_ff, n = case
    rng = np.random.default_rng(24)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    emb, ones = t(b, d), torch.ones(d)
    if d_ff > 2048:  # the widest width: weights of no size, the plan alone
        blocks = [(ones, torch.empty(d, 2 * d_ff), torch.empty(d_ff, d))]
    else:
        blocks = [(1 + t(d), t(d, 2 * d_ff), t(d_ff, d)) for _ in range(n)]
    try:
        out = fused_mapping.mapping_forward(emb, ones, ones, blocks,
                                            dtype=torch.float32)
    finally:
        FUSED_F32_PLAN.cache_clear()
    (entry, args), = fake_library
    assert entry == "kdt_mapping_f32"
    assert [id(x) for x in seen] == [id(x) for x in (emb, ones, ones, out)]
    weights = [p for p in args[3]]
    assert weights == [w.data_ptr() for blk in blocks for w in blk]
    assert args[5:11] == [b, d, d_ff, n, *F32_MAPPING_PLANS[case]]
    assert args[13:] == [None, None]
    assert out.shape == (b, d) and out.dtype == torch.float32
    assert counts(fused_mapping)[:2] == (0, 1)


@pytest.mark.parametrize("d,d_ff", [(4544, 8192), (8192, 768), (2048, 65536)])
def test_float32_mapping_refuses_past_its_width_before_any_launch(
        fake_library, d, d_ff):
    """Where a strip of 8 rows and two weight stages do not fit one
    block's shared memory, K5-f32 raises ValueError by name before any
    launch or occupancy query; d 4 480 at d_ff 8 192 and the ViT's and
    the HDiT's widths fit."""
    emb, ones = torch.zeros(1, d), torch.ones(d)
    blocks = [(ones, torch.empty(d, 0), torch.empty(d_ff, 0))]
    with pytest.raises(ValueError, match="fused_mapping float32 kernel"):
        fused_mapping.mapping_forward(emb, ones, ones, blocks,
                                      dtype=torch.float32)
    assert not fake_library
    for ok in ((4480, 8192), (2048, 8192), (768, 2048), (256, 768)):
        fused_mapping.f32_check_width(*ok)


@pytest.mark.parametrize("case", [(2, 7, 7, 128, 2), (3, 4, 4, 64, 2),
                                  (1, 2, 2, 832, 13)])
def test_float32_prologue_forward_scratch_is_what_the_entry_point_is_told(
        fake_library, monkeypatch, case):
    """K1-f32's forward gets the rounded W_qkv^T, (3d, d) float32, as
    kdt_fused_qkv_f32 is told (csrc/fused_qkv_f32.cu), at head dims 64 and
    32 and at d = 832, past the bf16 form's 768; one launch counted."""
    seen = []

    def ptr(t):
        seen.append(t)
        return ctypes.c_void_p(t.data_ptr())

    monkeypatch.setattr(_build, "ptr", ptr)
    rng = np.random.default_rng(20)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    b, h, w, d, heads = case
    fused_qkv.prologue_forward(t(b, h, w, d), t_rope.make_axial_pos(h, w),
                               1 + t(b, d), t(d, 3 * d),
                               torch.full((heads,), 10.0), heads)
    (entry, args), = fake_library
    assert entry == "kdt_fused_qkv_f32" and len(seen) == 10
    assert args[10:15] == [b, h * w, d, heads, d]
    wt = seen[9]
    assert wt.dtype == torch.float32 and wt.is_contiguous()
    assert tuple(wt.shape) == (3 * d, d)
    assert counts(fused_qkv)[:2] == (0, 1)


@pytest.mark.parametrize("name,case", [
    ("fused_ffn", (1, 16, 96, 192)), ("fused_ffn", (1, 16, 128, 96)),
    ("fused_qkv", (1, 4, 4, 96, 3)), ("fused_qkv", (1, 4, 4, 128, 1)),
    ("fused_qkv", (1, 4, 4, 128, 8))])
def test_float32_forwards_refuse_before_any_launch(fake_library, name, case):
    """K4-f32's forward refuses d or d_ff not a multiple of 64, K1-f32's a d
    not a multiple of 64 and head dims other than 32 and 64 (128, 16), with
    ValueError before anything launches."""
    rng = np.random.default_rng(21)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    if name == "fused_ffn":
        b, tok, d, d_ff = case
        call = lambda: fused_ffn.ffn_forward(
            t(b, tok, d), 1 + t(b, d), t(d, 2 * d_ff), t(d_ff, d))
    else:
        b, h, w, d, heads = case
        call = lambda: fused_qkv.prologue_forward(
            t(b, h, w, d), t_rope.make_axial_pos(h, w), 1 + t(b, d),
            t(d, 3 * d), torch.full((heads,), 10.0), heads)
    with pytest.raises(ValueError):
        call()
    assert not fake_library


def test_cpu_float32_takes_the_plain_versions(fake_library):
    """float32 CPU tensors go to the plain versions: no launch."""
    for name in ENTRIES:
        args = operands(name, torch.float32)
        if name == "fused_qkv":
            fused_qkv.fused_qkv_prologue(*args)
        elif name == "fused_ffn":
            fused_ffn.fused_geglu_ffn(*args)
        elif name == "fused_mapping":
            fused_mapping.fused_mapping(*args, dtype=torch.float32)
        else:
            global_packed.packed_global_attention(*args)
    assert not fake_library


# ---- K3's float32 residuals under a save_* policy -------------------------------

def test_packed_attention_stash_keeps_float32_residuals():
    """Under a ``save_attn_out`` layer, K3's autograd node keeps float32
    (out, lse) in the Stash as they are: the recompute reads them back with
    no forward call, and K9's backward gets them, and dout, in float32."""
    (q0, k0, v0), (dout,) = gp_case(10, 2, 64, 2)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q0, k0, v0))
    dout = torch.from_numpy(dout)
    seen = []

    def forward(q, k, v):
        seen.append("forward")
        return (global_packed.reference(q, k, v, 2),
                global_packed.reference_lse(q, k, v, 2))

    def backward(q, k, v, out, lse, dout):
        seen.append((out.dtype, lse.dtype, dout.dtype))
        return global_packed.reference_backward(q, k, v, dout, 2)

    stash = residuals.Stash()
    with residuals.recording(stash, replay=False):
        first = residuals.attention(q, k, v, forward, backward)
    with residuals.recording(stash, replay=True):
        out = residuals.attention(q, k, v, forward, backward)
    assert stash.kept[0][0].dtype == stash.kept[0][1].dtype == torch.float32
    assert stash.kept[0][1].shape == (2, 2, 64)
    assert torch.equal(out, first)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert seen == ["forward", (torch.float32,) * 3]
    want = global_packed.reference_backward(q, k, v, dout, 2)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref)


# ---- the trainer against JAX ------------------------------------------------------

BATCH, STEPS = 2, 2
# a learning rate at which 2 AdamW steps move the params far past TOL
LR = 3e-3


def randomized(params, seed):
    """Seeded noise into every kernel, the zero-initialised ones included;
    scales perturbed; the FourierFeatures bases kept."""
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        if path[-1].key == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.sqrt(np.prod(p.shape[:-1]))
        return p * (1 + 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fill, params)


def cifar10_transformer():
    """config_cifar10_transformer.json narrowed: 16 x 16 inputs (8 x 8 and 4
    x 4 tokens), widths 64 and 128 (one and two global heads of 64), one
    layer a level, the mapping network at width 64; dropout,
    augmentation and classes off (their draws differ between the
    frameworks)."""
    config = json.loads((REPO / "configs" /
                         "config_cifar10_transformer.json").read_text())
    config["model"].update(input_size=[16, 16], widths=[64, 128],
                           depths=[1, 1], d_ffs=[192, 384], mapping_width=64,
                           mapping_d_ff=192, dropout_rate=0.0,
                           augment_prob=0.0)
    return config


def oxford_flowers_na():
    """config_oxford_flowers.json narrowed, its neighborhood attention kept:
    32 x 32 inputs at patch 4 (8 x 8 tokens at a 7 x 7 neighborhood level
    of one head of 64, then 4 x 4 tokens at a global level of two), widths
    64 and 128, one layer a level, the mapping network at width 64;
    dropout off."""
    config = json.loads((REPO / "configs" /
                         "config_oxford_flowers.json").read_text())
    config["model"].update(
        input_size=[32, 32], widths=[64, 128], depths=[1, 1],
        d_ffs=[192, 384], self_attns=[
            {"type": "neighborhood", "d_head": 64, "kernel_size": 7},
            {"type": "global", "d_head": 64}],
        dropout_rate=[0.0, 0.0], mapping_width=64, mapping_d_ff=192)
    return config


def oxford_flowers_na128():
    """config_oxford_flowers.json with head dim 128 at its neighborhood
    levels, narrowed: 32 x 32 inputs at patch 2 (16 x 16 tokens at an NA
    level of one head of 128, 8 x 8 at one of two, then 4 x 4 tokens at a
    global level of four heads of 64), widths 128, 256, 256, one layer a
    level, the mapping network at width 64; dropout off. Its NA levels run
    the plain prologue and the per-head NA (K11/K12 on the card), its
    global level the fused prologue."""
    config = json.loads((REPO / "configs" /
                         "config_oxford_flowers.json").read_text())
    config["model"].update(
        input_size=[32, 32], patch_size=[2, 2], widths=[128, 256, 256],
        depths=[1, 1, 1], d_ffs=[384, 768, 768], self_attns=[
            {"type": "neighborhood", "d_head": 128, "kernel_size": 7},
            {"type": "neighborhood", "d_head": 128, "kernel_size": 7},
            {"type": "global", "d_head": 64}],
        dropout_rate=[0.0, 0.0, 0.0], mapping_width=64, mapping_d_ff=192)
    return config


def small_vit():
    """A ViT of 2 layers at width 128 (2 heads of 64) on 16 x 16 inputs,
    patch 2, EDM's training density; dropout off."""
    return {"model": {"type": "image_transformer_v1", "input_channels": 3,
                      "input_size": [16, 16], "patch_size": 2, "depth": 2,
                      "width": 128, "dropout_rate": 0.0, "sigma_data": 0.5,
                      "sigma_min": 1e-2, "sigma_max": 80.0,
                      "sigma_sample_density": {"type": "lognormal",
                                               "mean": -1.2, "std": 1.2}},
            "optimizer": {"type": "adamw", "lr": LR, "betas": [0.9, 0.95],
                          "eps": STEP_EPS, "weight_decay": 1e-4}}


FAMILIES = {"cifar10_transformer": cifar10_transformer, "vit": small_vit,
            "oxford_flowers_na": oxford_flowers_na,
            "oxford_flowers_na128": oxford_flowers_na128}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float32_training_run_matches_jax(tmp_path, monkeypatch, family):
    """``train.run`` with ``--mixed-precision no --device cpu`` for 2 steps
    (weights from ``--resume-inference``, synthetic data) against JAX's
    float32 step from the same weights: the trainer's batches and EMA
    decays are recorded, each step's sigmas and noise are JAX's draws from
    its key, injected. Each step's loss, and the params and EMA after 2
    steps, within 2e-4 (the params having moved by more than 10x that)."""
    config = FAMILIES[family]()
    config.setdefault("optimizer", {}).update(eps=STEP_EPS, lr=LR)
    size = config["model"]["input_size"][0]
    config["dataset"] = {"type": "synthetic", "length": BATCH}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    config = K.config.load_config(path)
    model = K.config.make_model(config)
    params = randomized(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
        jnp.ones((1,)))["params"], 19)
    weights = tmp_path / "weights.safetensors"
    checkpoint.save_inference(
        weights, convert.state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, params)), config, dtype=torch.float32)

    density = K.config.make_sample_density(config["model"])
    shape = (1, BATCH, size, size, 3)
    keys = [jax.random.PRNGKey(40 + i) for i in range(STEPS)]
    draws = []
    for key in keys:  # the draws JAX's step makes from its key
        k_sigma, k_loop = jax.random.split(key)
        sigmas = np.array(density(k_sigma, (BATCH,), stratified=(0, 1)))
        k_noise, _, _ = jax.random.split(jax.random.fold_in(k_loop, 0), 3)
        folded = j_layout.fold_images(jnp.zeros(shape[1:])).shape
        noise = np.array(jax.random.normal(k_noise, folded)).reshape(shape)
        draws.append((sigmas, noise))

    seen = []
    make_step = t_training.make_train_step

    def recording(denoiser_factory, sample_density, **kw):
        def injected(shape, stratified=None, generator=None, device=None):
            return torch.from_numpy(draws[len(seen)][0]).reshape(shape)

        step = make_step(denoiser_factory, injected, **kw)

        def run(state, batch, generator, ema_decay):
            assert next(state.model.parameters()).dtype == torch.float32
            assert state.model.dtype == torch.float32
            metrics = step(state, batch, generator, ema_decay,
                           noise=torch.from_numpy(draws[len(seen)][1]))
            seen.append({"batch": {k: v.clone() for k, v in batch.items()},
                         "ema_decay": ema_decay,
                         "loss": float(metrics["loss"]),
                         "params": {k: v.clone() for k, v in
                                    state.model.state_dict().items()},
                         "ema": {k: v.clone() for k, v in
                                 state.ema_model.state_dict().items()}})
            return metrics
        return run

    monkeypatch.setattr(t_training, "make_train_step", recording)
    t_train.main(["--config", str(path), "--device", "cpu",
                  "--mixed-precision", "no", "--batch-size", str(BATCH),
                  "--num-workers", "1", "--name", str(tmp_path / "run"),
                  "--end-step", str(STEPS), "--save-every", "0",
                  "--demo-every", "0", "--evaluate-every", "0",
                  "--resume-inference", str(weights)])
    assert len(seen) == STEPS

    opt = K.training.make_optimizer(config, j_itv2.param_group_labels(params))
    state = K.training.TrainState(
        step=jnp.int32(0), params=params, opt_state=opt.init(params),
        ema_params=jax.tree_util.tree_map(jnp.array, params))
    step = K.training.make_train_step(
        model, K.config.make_denoiser_wrapper(config), density, opt)
    for key, record in zip(keys, seen):
        batch = {k: jnp.asarray(v.numpy()) for k, v in record["batch"].items()}
        state, metrics = step(state, batch, key, record["ema_decay"])
        want = float(metrics["loss"])
        assert abs(record["loss"] - want) <= TOL * abs(want), (record["loss"],
                                                                want)
    before = convert.flatten(jax.tree_util.tree_map(np.asarray, params))
    moved = max(np.abs(seen[-1]["params"][k].numpy() - v).max() /
                np.abs(v).max() for k, v in before.items()
                if not k.endswith(".basis"))
    assert moved > 10 * TOL, moved
    for tree, kind in ((state.params, "params"), (state.ema_params, "ema")):
        want = convert.flatten(jax.tree_util.tree_map(np.asarray, tree))
        for name, got in seen[-1][kind].items():
            close(got.numpy(), want[name], TOL, f"{kind} {name}")
