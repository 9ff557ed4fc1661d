"""Float32 compute on the card (``--mixed-precision no``) for the HDiT's
neighborhood-attention levels, on the CPU: the plain versions of the
kernels whose float32 forms this slice adds (K2/K7 on channel-packed maps,
K11/K12 per head) against the JAX package in float32, its dispatchers and
its Pallas bodies in interpret mode, forward and backward; each wrapper's
dispatch by dtype with the library stood in for, and its refusals (float16,
mixed dtypes, float32 strides that are not multiples of 16 bytes, head dim
128 in float32, K15 in float32); and the float32 residual stash of
K2 under a ``save_attn_out`` layer. Same float32 inputs on both sides, made
with numpy from a seed. The arithmetic of the TF32 kernels over the
neighborhood geometry is mirrored in tests/test_torch_na_geometry.py, and
2 float32 trainer steps of a narrowed flagship against JAX's are in
tests/test_torch_float32_transformers.py."""

import ctypes
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d
from k_diffusion_tpu_torch.ops.kernels import _build, na2d, residuals

torch.set_num_threads(2)

j_na = importlib.import_module("k_diffusion_tpu.ops.pallas.na2d")

# float32 on both sides, the same operations summed in another order
F32_TOL = 2e-5
TILE = 8  # the Pallas bodies' query tile here

# (head dim, kernel size, h, w) of the plain versions against JAX
CASES = [(e, ks, h, w) for e in (64, 32) for ks in (7, 3)
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
    heads * e = 128, the width at which the Pallas packed body takes both
    head dims."""
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


@pytest.mark.parametrize("e,ks,h,w", CASES)
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


# the wrapper's launch counters: K2, K7, K11, K12 in bf16, then in float32
COUNTERS = ("launches", "bwd_launches", "heads_launches", "heads_bwd_launches",
            "launches_f32", "bwd_launches_f32", "heads_launches_f32",
            "heads_bwd_launches_f32")
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(ENTRIES))
def test_na_wrappers_dispatch_by_dtype(fake_library, layout, dtype):
    """float32 operands reach the float32 entry points and counters,
    bfloat16 the bf16 ones, with the shape, the kernel size, the scale and
    (per head) q's, k's and v's strides; the outputs and the gradients are
    in the operands' dtype, the lse float32."""
    q, k, v, dout = operands(layout, dtype)
    (out, lse), grads = forward_and_backward(layout, q, k, v, dout)
    (e_fwd, a_fwd), (e_bwd, a_bwd) = fake_library
    assert (e_fwd, e_bwd) == ENTRIES[layout][dtype]
    assert a_fwd[:3] == [t.data_ptr() for t in (q, k, v)]
    assert a_bwd[:5] == [t.data_ptr() for t in (q, k, v, out, dout)]
    if layout == "packed":
        assert a_fwd[5:11] == a_bwd[10:16] == [2, 16, 8, 2, 7, 0.5]
    else:
        strides = [st for t in (q, k, v) for st in t.stride()[:3]]
        assert strides[6:] == [16 * 8 * 3 * 128, 8 * 3 * 128, 3 * 128]
        assert a_fwd[5:12] == a_bwd[10:17] == [2, 16, 8, 2, 64, 7, 0.5]
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


def test_float32_refusals_by_name(fake_library):
    """What has no float32 form yet raises ValueError naming it before any
    launch: K11 and K12 at head dim 128 (their bf16 forms take it), K15
    (``na2d_packed_proj``, its op path and its launch), each naming
    ROADMAP.md."""
    q, k, v, dout = operands("heads", torch.float32, e=128)
    with pytest.raises(ValueError, match="head dim 128 has no float32 form"):
        na2d.heads_forward(q, k, v, 7)
    out, lse = torch.zeros(q.shape), torch.zeros((2, 1, 16, 8))
    with pytest.raises(ValueError, match="head dim 128 has no float32 form"):
        na2d.heads_backward(q, k, v, out, lse, dout, 7)
    bf = operands("heads", torch.bfloat16, e=128)
    na2d.heads_forward(*bf[:3], 7)  # the bf16 form takes head dim 128
    assert [e for e, _ in fake_library] == ["kdt_na2d_heads"]
    fake_library.clear()
    x = operands("packed", torch.float32)[0]
    eye = torch.eye(128)
    for call in (lambda: na2d.proj_forward(x, x, x, x, eye, 2, 7),
                 lambda: na2d.na2d_packed_proj(
                     *(t.to("meta") for t in (x, x, x, x, eye)), 2, 7)):
        with pytest.raises(ValueError, match=r"K15-f32.*ROADMAP.md queue 2"):
            call()
    assert not fake_library


def test_cpu_float32_takes_the_plain_versions(fake_library):
    """float32 CPU tensors go to the plain versions: no launch."""
    q, k, v, _ = operands("packed", torch.float32)
    na2d.na2d_packed(q, k, v, 2, 7)
    na2d.na2d(*operands("heads", torch.float32, e=32)[:3], 7)
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
