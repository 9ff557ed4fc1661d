"""Float32 compute on the card (``--mixed-precision no``) for the HDiT's
neighborhood-attention levels, on the CPU: the plain versions of the
neighborhood kernels' float32 forms (K2/K7 on channel-packed maps, K11/K12
per head at head dims 32, 64 and 128, K15 with its out-projection, K8's
overlap-add writing float32) against the JAX package in float32, its
dispatchers and its Pallas bodies in interpret mode, forward and backward;
each wrapper's dispatch by dtype with the library stood in for, and its
refusals (float16, mixed dtypes, float32 strides that are not multiples of
16 bytes); the float32 residual stash of K2 under a ``save_attn_out``
layer; and the flagship with head dim 128 at its neighborhood levels,
narrowed: its prologue routed by ``fused_qkv.takes`` (the plain prologue at
the NA levels, K1 at the global one) and its eval forward against the JAX
model in float32. Same float32 inputs on both sides, made with numpy from
a seed. The arithmetic of the TF32 kernels over the neighborhood geometry
is mirrored in tests/test_torch_na_geometry.py, and 2 float32 trainer
steps of narrowed flagships (NA head dim 64 and 128) against JAX's are in
tests/test_torch_float32_transformers.py."""

import ctypes
import functools
import importlib

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch.models import image_transformer_v2 as t_itv2
from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d
from k_diffusion_tpu_torch.ops.kernels import _build, na2d, residuals

torch.set_num_threads(2)

j_na = importlib.import_module("k_diffusion_tpu.ops.pallas.na2d")

# float32 on both sides, the same operations summed in another order
F32_TOL = 2e-5
TILE = 8  # the Pallas bodies' query tile here

# (head dim, kernel size, h, w) of the plain versions against JAX; the
# per-head ones also at head dim 128 (one head)
CASES = [(e, ks, h, w) for e in (64, 32) for ks in (7, 3)
         for h, w in ((16, 16), (8, 24))]
HEADS_CASES = CASES + [(128, ks, h, w) for ks in (7, 3)
                       for h, w in ((16, 16), (8, 24))]


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def unit_heads(rng, *shape):
    """q/k as the prologue makes them: norm sqrt(10) per head over the last
    axis, so logits stay in [-10, 10] (the Pallas NA bodies skip the max)."""
    t = rand(rng, *shape)
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)
            * np.sqrt(10.0)).astype(np.float32)


def close(got, want, tol=F32_TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


def close_all(got, want):
    assert len(got) == len(want)
    for i, (a, b_) in enumerate(zip(got, want)):
        close(a, b_, name=str(i))


def port_vjp(fn, inputs, cot):
    """(output, input gradients of <fn(*inputs), cot>) through the port."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(cot))


def jax_vjp(fn, inputs, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    return out, vjp(jnp.asarray(cot))


def heads_case(seed, e, h, w, b=1):
    """q, k (cosine-sim per head), v, dout (b, h, w, heads, e) float32 with
    heads * e = 128, the width at which the Pallas packed body takes head
    dims 32 and 64 (one head at 128)."""
    rng = np.random.default_rng(seed)
    shape = (b, h, w, 128 // e, e)
    return (unit_heads(rng, *shape), unit_heads(rng, *shape),
            rand(rng, *shape), rand(rng, *shape))


# ---- the plain versions against the JAX package in float32 --------------------

@pytest.mark.parametrize("e,ks,h,w", CASES)
def test_na2d_packed_float32_matches_jax(e, ks, h, w):
    """The plain versions of K2 and K7 (``na2d_packed`` on float32 CPU
    tensors, autograd through ``reference``) against the JAX dispatcher's
    forward and VJP and against the Pallas bodies in interpret mode: the
    packed forward with lse, then its backward (dq and the per-tile dk/dv
    halo partials, and their overlap-add)."""
    b = 2 if ks == 3 else 1
    heads = 128 // e
    q, k, v, dout = (t.reshape(b, h, w, 128) for t in heads_case(e + ks, e, h,
                                                                 w, b))
    got, grads = port_vjp(lambda *t: na2d.na2d_packed(*t, heads, ks),
                          (q, k, v), dout)
    assert got.dtype == torch.float32
    want, want_grads = jax_vjp(lambda *t: j_na.na2d_packed(*t, heads, ks),
                               (q, k, v), dout)
    close(got, want)
    close_all(grads, want_grads)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        out, lse, k_halo, v_halo = j_na._na_packed_fwd(
            qj, kj, vj, ks, 1.0, TILE, heads, save_lse=True)
        body_grads = j_na._na_packed_bwd(ks, 1.0, TILE, heads,
                                         (qj, k_halo, v_halo, out, lse),
                                         jnp.asarray(dout))
    close(got, out)
    close_all(grads, body_grads)


def pack(t):
    """(b, h, w, heads, e) -> (b * heads, h, w, e), the JAX dispatcher's
    pack."""
    b, h, w, heads, e = t.shape
    return jnp.moveaxis(jnp.asarray(t), 3, 1).reshape(b * heads, h, w, e)


def unpack(t, b):
    n, h, w, e = t.shape
    return np.moveaxis(np.asarray(t).reshape(b, n // b, h, w, e), 1, 3)


@pytest.mark.parametrize("e,ks,h,w", HEADS_CASES)
def test_na2d_heads_float32_matches_jax(e, ks, h, w):
    """The plain versions of K11 and K12 (``na2d`` on float32 CPU tensors, v
    a strided third of a projection) against the JAX dispatcher's forward
    and VJP and against the Pallas bodies in interpret mode (``_na_fwd``,
    its lse beside the plain masked logsumexp, and ``_na_bwd``)."""
    q, k, v, dout = heads_case(2 * e + ks, e, h, w)
    proj = np.stack([q, k, v], 3)  # (b, h, w, 3, heads, e)
    leaves = [torch.from_numpy(proj).requires_grad_()]
    got = na2d.na2d(*leaves[0].unbind(3), ks)
    assert not leaves[0].unbind(3)[2].is_contiguous()
    (dproj,) = torch.autograd.grad(got, leaves, torch.from_numpy(dout))
    grads = dproj.unbind(3)
    want, want_grads = jax_vjp(lambda *t: j_na.na2d(*t, ks), (q, k, v), dout)
    close(got, want)
    close_all(grads, want_grads)
    qp, kp, vp = pack(q), pack(k), pack(v)
    with pltpu.force_tpu_interpret_mode():
        out, lse = j_na._na_fwd(qp, kp, vp, ks, 1.0, TILE)
        body_grads = j_na._na_bwd(ks, 1.0, TILE, (qp, kp, vp, out, lse),
                                  pack(dout))
    close(got, unpack(out, 1))
    close_all(grads, [unpack(t, 1) for t in body_grads])
    # the Pallas lse, tilewise (n, tiles_h, tiles_w, 64, 1) -> (n, h, w):
    # the log of the max-free sum, as the plain masked logsumexp
    n = q.shape[3]
    lse = np.asarray(lse).reshape(n, h // TILE, w // TILE, TILE, TILE)
    lse = lse.transpose(0, 1, 3, 2, 4).reshape(n, h, w)
    logits = torch.einsum("bhwne,bkne->bnhwk", torch.from_numpy(q),
                          torch.from_numpy(k).reshape(1, h * w, n, e))
    mask = neighborhood_mask_2d(h, w, ks, "cpu").reshape(h, w, h * w)
    plain = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    close(plain.reshape(n, h, w), lse)


# (c, e) of K15's plain version against JAX: c = 128 at head dims 64 and 32
# (2 and 4 heads, the Pallas body takes both), and c = 256
PROJ_CASES = [(128, 64), (128, 32), (256, 64)]


@pytest.mark.parametrize("c,e", PROJ_CASES)
def test_na2d_packed_proj_float32_matches_jax(c, e):
    """K15-f32's plain version (``na2d_packed_proj`` on float32 CPU tensors:
    ``proj_reference``, NA(q, k, v) @ w_out + skip, and autograd through
    it) against the JAX dispatcher's forward and VJP, and against its
    custom_vjp with the interpret-mode Pallas body ``_na_packed_proj_fwd``
    as the forward (its backward the VJP of the reference, as the port's
    recomputes)."""
    heads = c // e
    rng = np.random.default_rng(c + e)
    shape = (1, 16, 16, heads, e)
    q, k = (unit_heads(rng, *shape).reshape(1, 16, 16, c) for _ in range(2))
    v, skip, dout = (rand(rng, 1, 16, 16, c) for _ in range(3))
    w_out = (rand(rng, c, c) * c ** -0.5).astype(np.float32)
    inputs = (q, k, v, skip, w_out)
    got, grads = port_vjp(
        lambda *t: na2d.na2d_packed_proj(*t, heads, 7), inputs, dout)
    assert got.dtype == torch.float32
    close(got, na2d.proj_reference(*map(torch.from_numpy, inputs), heads, 7))
    want, want_grads = jax_vjp(
        lambda *t: j_na.na2d_packed_proj(*t, heads, 7), inputs, dout)
    close(got, want)
    close_all(grads, want_grads)
    with pltpu.force_tpu_interpret_mode():
        body = j_na._na_packed_proj_fwd(*map(jnp.asarray, inputs), 7, 1.0,
                                        TILE, heads)
        _, body_grads = jax_vjp(
            lambda *t: j_na._na2d_packed_proj_inner(*t, 7, 1.0, TILE, heads),
            inputs, dout)
    close(got, body)
    close_all(grads, body_grads)


@pytest.mark.parametrize("ks,h,w", [(7, 16, 16), (3, 8, 24), (7, 16, 24)])
def test_overlap_add_float32_matches_jax(ks, h, w):
    """K8-f32's plain version (``overlap_add_reference`` with dtype
    float32) of the plain per-tile halo partials
    (``packed_backward_partials_reference``) against dk and dv of the JAX
    ``na2d_packed``'s VJP in float32, its dispatcher and its Pallas
    backward in interpret mode, whose dk, dv are its own overlap-add of its
    own halo partials."""
    heads = 2
    q, k, v, dout = (t.reshape(1, h, w, 128) for t in heads_case(ks + h, 64,
                                                                 h, w))
    parts = na2d.packed_backward_partials_reference(
        *map(torch.from_numpy, (q, k, v, dout)), heads, ks)
    assert all(p.dtype == torch.float32 for p in parts)
    got = na2d.overlap_add_reference(*parts, h, w, ks, dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in got)
    _, want = jax_vjp(lambda *t: j_na.na2d_packed(*t, heads, ks), (q, k, v),
                      dout)
    close_all(got, want[1:])
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        out, lse, k_halo, v_halo = j_na._na_packed_fwd(
            qj, kj, vj, ks, 1.0, TILE, heads, save_lse=True)
        body = j_na._na_packed_bwd(ks, 1.0, TILE, heads,
                                   (qj, k_halo, v_halo, out, lse),
                                   jnp.asarray(dout))
    close_all(got, body[1:])


# ---- each wrapper's dispatch by dtype ------------------------------------------

@pytest.fixture
def fake_library(monkeypatch):
    """The kernel libraries stood in for: each launch records (entry, its
    arguments as Python values) and returns status 0; CPU tensors pass the
    CUDA check, so every wrapper's launch path runs here."""
    calls = []

    def launch(lib, entry, what, device, *args):
        calls.append((entry, [list(a) if isinstance(a, ctypes.Array) else
                              a.value if isinstance(a, ctypes.c_void_p)
                              else a for a in args]))

    monkeypatch.setattr(_build, "load", lambda name, **_: None)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    for attr in COUNTERS:
        monkeypatch.setattr(na2d, attr, 0)
    return calls


# the wrapper's launch counters: K2, K7, K11, K12, K15, K8 in bf16, then in
# float32
COUNTERS = ("launches", "bwd_launches", "heads_launches", "heads_bwd_launches",
            "proj_launches", "overlap_launches", "launches_f32",
            "bwd_launches_f32", "heads_launches_f32", "heads_bwd_launches_f32",
            "proj_launches_f32", "overlap_launches_f32")
ENTRIES = {  # layout -> dtype -> (forward entry, backward entry)
    "packed": {torch.float32: ("kdt_na2d_packed_f32", "kdt_na2d_packed_bwd_f32"),
               torch.bfloat16: ("kdt_na2d_packed", "kdt_na2d_packed_bwd")},
    "heads": {torch.float32: ("kdt_na2d_heads_f32", "kdt_na2d_heads_bwd_f32"),
              torch.bfloat16: ("kdt_na2d_heads", "kdt_na2d_heads_bwd")},
}


def operands(layout, dtype, e=64, seed=3):
    """q, k, v and dout at a small size: packed (2, 16, 8, 128), or per head
    (2, 16, 8, heads, e), v a strided third of one projection."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rand(rng, *shape)).to(dtype)
    if layout == "packed":
        return tuple(t(2, 16, 8, 128) for _ in range(4))
    heads = 128 // e
    q, k, v = t(2, 16, 8, 3, heads, e).unbind(3)
    return q.contiguous(), k.contiguous(), v, t(2, 16, 8, heads, e)


def forward_and_backward(layout, q, k, v, dout):
    """The wrapper's forward entry with lse, then its backward."""
    if layout == "packed":
        out, lse = na2d.packed_forward(q, k, v, 2, 7, 0.5, save_lse=True)
        return (out, lse), na2d.packed_backward(q, k, v, out, lse, dout, 2, 7,
                                                0.5)
    out, lse = na2d.heads_forward(q, k, v, 7, 0.5, save_lse=True)
    return (out, lse), na2d.heads_backward(q, k, v, out, lse, dout, 7, 0.5)


# (layout, head dim): the packed maps, and the per-head ones at every head
# dim of K11 and K12 ("heads" at 64)
LAYOUTS = {"packed": ("packed", 64), "heads": ("heads", 64),
           "heads-e32": ("heads", 32), "heads-e128": ("heads", 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout, e", list(LAYOUTS.values()),
                         ids=list(LAYOUTS))
def test_na_wrappers_dispatch_by_dtype(fake_library, layout, e, dtype):
    """float32 operands reach the float32 entry points and counters,
    bfloat16 the bf16 ones, with the shape, the kernel size, the scale and
    (per head, at head dims 32, 64 and 128, v a strided third of a
    projection) q's, k's and v's strides; each dtype's backward entry gets
    the same arguments at every head dim, a fresh float32 delta the dq
    kernel writes included (nothing here forms it); the outputs and the
    gradients are in the operands' dtype, the lse float32."""
    q, k, v, dout = operands(layout, dtype, e=e)
    (out, lse), grads = forward_and_backward(layout, q, k, v, dout)
    (e_fwd, a_fwd), (e_bwd, a_bwd) = fake_library
    assert (e_fwd, e_bwd) == ENTRIES[layout][dtype]
    assert a_fwd[:3] == [t.data_ptr() for t in (q, k, v)]
    assert a_bwd[:5] == [t.data_ptr() for t in (q, k, v, out, dout)]
    assert a_bwd[5] == lse.data_ptr()
    # delta: a pointer of its own, past out's and lse's, beside dq, dk, dv
    assert len(set(a_bwd[:10])) == 10 and None not in a_bwd[:10]
    # the float32 backward's TMA boxes and stores start on 16-byte bases
    assert all(p % 16 == 0 for p in a_bwd[:10])
    if layout == "packed":
        assert a_fwd[5:11] == a_bwd[10:16] == [2, 16, 8, 2, 7, 0.5]
    else:
        heads = 128 // e
        strides = [st for t in (q, k, v) for st in t.stride()[:3]]
        assert strides[6:] == [16 * 8 * 3 * 128, 8 * 3 * 128, 3 * 128]
        assert a_fwd[5:12] == a_bwd[10:17] == [2, 16, 8, heads, e, 7, 0.5]
        assert a_fwd[12] == a_bwd[17] == strides
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert all(g.dtype == dtype and g.shape == q.shape for g in grads)
    f32 = dtype == torch.float32
    names = ("launches", "bwd_launches") if layout == "packed" else (
        "heads_launches", "heads_bwd_launches")
    want = dict.fromkeys(COUNTERS, 0) | {
        f"{n}_f32" if f32 else n: 1 for n in names}
    assert {c: getattr(na2d, c) for c in COUNTERS} == want


@pytest.mark.parametrize("layout", list(ENTRIES))
@pytest.mark.parametrize("case", ["float16", "mixed", "stride", "out dtype"])
def test_na_wrappers_refuse_what_no_kernel_takes(fake_library, layout, case):
    """float16 operands, operands of mixed dtypes, a float32 stride that is
    not a multiple of 4 elements (16 bytes) and a backward's out of another
    dtype raise ValueError by name; nothing launches."""
    q, k, v, dout = operands(layout, torch.float32)
    match = {"float16": "bfloat16 or float32", "mixed": "dtype",
             "stride": "16-byte aligned", "out dtype": "dtype"}[case]
    if case == "float16":
        q, k, v, dout = operands(layout, torch.float16)
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "stride":
        # rows 2 floats (8 bytes) apart from a 16-byte multiple
        wide = torch.zeros((*q.shape[:2], q.shape[2] + 1, *q.shape[3:]))
        v = torch.as_strided(wide, q.shape, (*wide.stride()[:2], q.shape[-1] + 2
                                             if layout == "packed" else
                                             wide.stride(2) + 2,
                                             *wide.stride()[3:]))
    if case == "out dtype":
        out, lse = (torch.zeros(q.shape, dtype=torch.bfloat16),
                    torch.zeros((2, 2, 16, 8)))
        if layout == "packed":
            call = lambda: na2d.packed_backward(q, k, v, out, lse, dout, 2, 7)
        else:
            call = lambda: na2d.heads_backward(q, k, v, out, lse, dout, 7)
    else:
        call = lambda: forward_and_backward(layout, q, k, v, dout)
    with pytest.raises(ValueError, match=match):
        call()
    assert not fake_library


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", na2d.HEAD_DIMS)
def test_heads_backward_forms_no_delta(fake_library, e, dtype):
    """K12's wrapper leaves delta = rowsum(out * dout) to the dq kernel at
    every head dim and in either dtype: under a dispatch mode that records
    every aten op, it issues no product and no sum (it only allocates and
    launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    q, k, v, dout = operands("heads", dtype, e=e)
    out, lse = na2d.heads_forward(q, k, v, 7, 0.5, save_lse=True)
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Record():
        na2d.heads_backward(q, k, v, out, lse, dout, 7, 0.5)
    assert ops and not {"mul", "sum", "mean", "einsum", "bmm", "mm"} & set(ops)
    assert fake_library[-1][0] == ENTRIES["heads"][dtype][1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_dispatches_by_dtype(fake_library, dtype):
    """K15's wrapper sends float32 operands to ``kdt_na2d_proj_f32`` with
    the float32 w_out as it is, bfloat16 to ``kdt_na2d_proj`` with w_out
    cast, with the shape, heads, head dim, kernel size and scale; the
    output in the operands' dtype; each on its own counter."""
    x = operands("packed", dtype)[0]
    w_out = torch.eye(128)
    out = na2d.proj_forward(x, x, x, x, w_out, 2, 7, 0.5)
    (entry, args), = fake_library
    f32 = dtype == torch.float32
    assert entry == ("kdt_na2d_proj_f32" if f32 else "kdt_na2d_proj")
    assert args[:4] == [x.data_ptr()] * 4
    assert (args[4] == w_out.data_ptr()) == f32
    assert args[6:13] == [2, 16, 8, 2, 64, 7, 0.5]
    assert out.dtype == dtype and out.shape == x.shape
    want = dict.fromkeys(COUNTERS, 0) | {
        "proj_launches_f32" if f32 else "proj_launches": 1}
    assert {c: getattr(na2d, c) for c in COUNTERS} == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_overlap_add_dispatches_by_dtype(fake_library, dtype):
    """K8 writes bfloat16 by default and float32 through
    ``kdt_na2d_overlap_add_f32`` where asked, with the shape, heads and
    kernel size; each on its own counter."""
    part = torch.zeros((2, 2, 2, na2d.HALO_KEYS, 64))
    f32 = dtype == torch.float32
    dk, dv = na2d.overlap_add(part, part, 16, 8, 7,
                              **({"dtype": dtype} if f32 else {}))
    (entry, args), = fake_library
    assert entry == ("kdt_na2d_overlap_add_f32" if f32
                     else "kdt_na2d_overlap_add")
    assert args[:2] == [part.data_ptr()] * 2
    assert args[4:9] == [2, 16, 8, 2, 7]
    assert dk.dtype == dv.dtype == dtype and dk.shape == (2, 16, 8, 128)
    want = dict.fromkeys(COUNTERS, 0) | {
        "overlap_launches_f32" if f32 else "overlap_launches": 1}
    assert {c: getattr(na2d, c) for c in COUNTERS} == want


def test_float32_refusals_by_name(fake_library):
    """What no kernel takes raises ValueError by name before any launch:
    float16 at K11 and K12 at head dim 128, at K15 (its op path and its
    launch) and as K8's output; float32 at those now launches (the
    dispatch tests above)."""
    q, k, v, dout = operands("heads", torch.float16, e=128)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.heads_forward(q, k, v, 7)
    out, lse = torch.zeros(q.shape, dtype=q.dtype), torch.zeros((2, 1, 16, 8))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.heads_backward(q, k, v, out, lse, dout, 7)
    x = operands("packed", torch.float16)[0]
    eye = torch.eye(128)
    for call in (lambda: na2d.proj_forward(x, x, x, x, eye, 2, 7),
                 lambda: na2d.na2d_packed_proj(
                     *(t.to("meta") for t in (x, x, x, x, eye)), 2, 7)):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            call()
    part = torch.zeros((2, 2, 2, na2d.HALO_KEYS, 64))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.overlap_add(part, part, 16, 8, 7, dtype=torch.float16)
    assert not fake_library


def test_cpu_float32_takes_the_plain_versions(fake_library):
    """float32 CPU tensors go to the plain versions: no launch."""
    q, k, v, _ = operands("packed", torch.float32)
    na2d.na2d_packed(q, k, v, 2, 7)
    na2d.na2d(*operands("heads", torch.float32, e=32)[:3], 7)
    na2d.na2d(*operands("heads", torch.float32, e=128)[:3], 7)
    na2d.na2d_packed_proj(q, k, v, q, torch.eye(128), 2, 7)
    assert not fake_library


# ---- K2's float32 residuals under a save_attn_out layer -----------------------

def test_packed_na_stash_keeps_float32_residuals(fake_library):
    """Under a ``save_attn_out`` layer, K2's autograd node (the wrapper's
    launch path, the library stood in for) keeps its float32 out and lse
    in the Stash as they are: the recompute reads them back with no
    launch, and K7's float32 backward gets them, and dout, in float32."""
    q, k, v, dout = operands("packed", torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    static = {"n_heads": 2, "kernel_size": 7, "scale": 1.0}
    forward = functools.partial(na2d.packed_forward, **static, save_lse=True)
    backward = functools.partial(na2d.packed_backward, **static)
    stash = residuals.Stash()
    with residuals.recording(stash, replay=False):
        first = residuals.attention(q, k, v, forward, backward)
    assert [e for e, _ in fake_library] == ["kdt_na2d_packed_f32"]
    with residuals.recording(stash, replay=True):
        out = residuals.attention(q, k, v, forward, backward)
    assert len(fake_library) == 1  # the recompute launched nothing
    kept_out, kept_lse = stash.kept[0]
    assert kept_out.dtype == kept_lse.dtype == torch.float32
    assert kept_lse.shape == (2, 2, 16, 8)
    assert out.data_ptr() == first.data_ptr() == kept_out.data_ptr()
    grads = torch.autograd.grad(out, (q, k, v), dout)
    (entry, args), = fake_library[1:]
    assert entry == "kdt_na2d_packed_bwd_f32"
    assert (args[3], args[5]) == (kept_out.data_ptr(), kept_lse.data_ptr())
    assert all(g.dtype == torch.float32 for g in grads)


# ---- the flagship with head dim 128 at its neighborhood levels --------------

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides: the bound of the model parity tests
MODEL_TOL = 2e-4


def na128_config(load_config):
    """config_oxford_flowers.json with head dim 128 at its neighborhood
    levels, narrowed: 32 x 32 inputs at patch 2 (16 x 16 tokens at an NA
    level of one head of 128, 8 x 8 at one of two, 4 x 4 at the global
    level of four heads of 64), widths 128, 256, 256, one layer a level,
    the mapping network at width 64; dropout off."""
    config = load_config(REPO / "configs" / "config_oxford_flowers.json")
    config["model"].update(
        input_size=[32, 32], patch_size=[2, 2], widths=[128, 256, 256],
        depths=[1, 1, 1], d_ffs=[384, 768, 768], mapping_width=64,
        mapping_d_ff=192, dropout_rate=[0.0, 0.0, 0.0])
    for attn in config["model"]["self_attns"]:
        if attn["type"] == "neighborhood":
            attn["d_head"] = 128
    return config


@pytest.mark.parametrize("training", [False, True])
def test_na128_prologue_routes_by_takes(monkeypatch, training):
    """The flagship with head dim 128 at its NA levels, narrowed: its eval
    forward and its fused training forward (KDT_TRAIN_FUSION=1) call the
    fused prologue (K1 on the card) at its global level only, where
    ``fused_qkv.takes`` is true, and the plain prologue at each NA layer
    (down and up stacks), which then runs the per-head ``na2d`` (K11)."""
    monkeypatch.setenv("KDT_TRAIN_FUSION", "1")
    calls = []

    def spy(name, orig):
        def call(*args, **kw):
            x = args[1] if name == "plain prologue" else args[0]
            # the layer's width: x's channels, or heads x e of q
            calls.append((name, x.shape[-1] if "prologue" in name or
                          name == "K1" else x.shape[-2] * x.shape[-1]))
            return orig(*args, **kw)
        return call

    for owner, attr, name in (
            (t_itv2, "fused_qkv_prologue", "K1"),
            (t_itv2.SelfAttentionBlock, "_unfused_prologue",
             "plain prologue"),
            (t_itv2, "na2d", "na2d"), (t_itv2, "na2d_packed", "na2d_packed")):
        monkeypatch.setattr(owner, attr, spy(name, getattr(owner, attr)))
    config = na128_config(KT.config.load_config)
    model = KT.config.make_model(config, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model.train(training)
    with torch.set_grad_enabled(training):
        out = model(torch.randn(2, 32, 32, 3), torch.ones(2))
    assert out.shape == (2, 32, 32, 3)
    na = [("plain prologue", 128), ("na2d", 128), ("plain prologue", 256),
          ("na2d", 256)]
    assert calls == na + [("K1", 256)] + na[2:] + na[:2]


def test_na128_forward_matches_jax():
    """The narrowed flagship with head dim 128 at its NA levels: the
    denoiser's eval forward through the new routing (the plain prologue at
    the NA levels, K11's plain version per head, K1's and K3's at the
    global level) against the JAX model in float32 from the same seeded
    weights (every zero-initialised kernel filled), within 2e-4 x
    max|JAX|; the blocks matter (the inner output is far from zero)."""
    config = na128_config(K.config.load_config)
    model = K.config.make_model(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32, 32, 3)),
                                 jnp.ones((1,)))["params"]
    rng = np.random.default_rng(12)

    def fill(path, p):
        p = np.asarray(p)
        if path[-1].key == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.sqrt(p.shape[0])
        return p * (1 + 0.1 * noise)

    params = jax.tree_util.tree_map_with_path(fill, params)
    port = KT.config.make_model(na128_config(KT.config.load_config),
                                device="cpu")
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    port.eval()
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    sigma = np.float32([0.4, 2.5])
    want = K.config.make_denoiser_wrapper(config)(
        lambda x, s: model.apply({"params": params}, x, s))(
            jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = KT.config.make_denoiser_wrapper(config)(port)(
            torch.from_numpy(x), torch.from_numpy(sigma))
        inner = port(torch.from_numpy(x), torch.from_numpy(sigma))
    close(got, want, MODEL_TOL)
    assert inner.std() > 0.1
