"""K1 and K6: the fused attention prologue and its backward (counterpart of
k_diffusion_tpu/ops/pallas/fused_qkv.py).

AdaRMSNorm(x, norm_scale) -> x @ W_qkv -> per-head cosine-sim scaling of q
and k -> axial RoPE on q and k, returning channel-packed (b, h, w, d) q, k, v.
CUDA tensors go to the hand-written kernels in ``csrc/fused_qkv.cu`` through
an autograd Function whose backward is the kernel K6; CPU tensors to
``reference``, the plain version, which autograd differentiates.

The forward reads each image's norm scale through a row stride, so that
``norm_scale`` may be a (b, d) column block of a condcache row (the JAX
kernel's BlockSpec lane block, ``scale_block``): no copy is made. That path
is forward-only; the backward K6 takes a contiguous scale.

bfloat16 operands go to those kernels, float32 operands (a model built
with ``dtype=torch.float32``, ``--mixed-precision no``) to their float32
forms in ``csrc/fused_qkv_f32.cu`` (``kdt_fused_qkv_f32`` and
``kdt_fused_qkv_bwd_f32``, both on the TF32 ``wgmma`` core
``csrc/gemm_tf32_wg.cuh``, each after a pass that copies the weight
rounded to TF32 into scratch the wrapper allocates): the same contract,
products on the TF32 tensor cores with f32 accumulation, any d a multiple
of 64. Each dtype's launches are counted apart, one a wrapper call.
"""

import ctypes
import functools

import torch

from .. import norms, rope
from . import _build

launches = 0      # forward kernel launches since the last reset, bfloat16
bwd_launches = 0  # backward kernel launches since the last reset, bfloat16
launches_f32 = 0      # forward launches on float32 operands
bwd_launches_f32 = 0  # backward launches on float32 operands

DTYPES = (torch.bfloat16, torch.float32)  # x dtypes the kernels take

HEAD_DIMS = (32, 64)  # head dims the kernels take
# the widest d the forward takes: two row tiles of x and its ring in one
# block's shared memory
MAX_D = 768

_P = ctypes.c_void_p
# x, norm_scale, w_qkv, attn_scale, pos, freqs, q, k, v, images, tokens, d,
# heads, step_panels, groups, scale_stride, eps, cos_eps, stream, blocks
# (int *: the occupancy query)
_SIGNATURE = [_P] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [_P] * 2
# x, norm_scale, w_qkv, attn_scale, cos, sin, gq, gk, gv, dx, dns, dw,
# das_sums, dqk, xn, r, dot_part, das_part, dns_part, dw_part, images,
# tokens, d, heads, groups, chunk_rows, eps, cos_eps, stream
_BWD_SIGNATURE = [_P] * 20 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, _P]
# the float32 forms: x, norm_scale, w_qkv, attn_scale, pos, freqs, q, k, v,
# wt, images, tokens, d, heads, scale_stride, eps, cos_eps, stream
_F32_SIGNATURE = [_P] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [_P]
# x, norm_scale, w_qkv, attn_scale, pos, freqs, gq, gk, gv, dx, dns, dw,
# das_sums, wt, w_r, drt, xn, r, dot_part, das_part, dns_part, dw_part,
# images, tokens, tiles, d, heads, ld, chunk_rows, eps, cos_eps, stream
_F32_BWD_SIGNATURE = [_P] * 22 + [ctypes.c_int] * 5 + [ctypes.c_long] * 2 + [
    ctypes.c_float, ctypes.c_float, _P]


def reference(x, pos, norm_scale, w_qkv, attn_scale, n_heads, eps=1e-6,
              cos_eps=1e-6):
    """Plain version, the chain of SelfAttentionBlock's unfused path.
    x (b, h, w, d); pos (h, w, 2); norm_scale (b, d); w_qkv (d, 3d);
    attn_scale (heads,)."""
    b, h, w, d = x.shape
    e = d // n_heads
    xn = norms.rms_norm(x, norm_scale[:, None, None, :], eps)
    qkv = (xn @ w_qkv.to(xn.dtype)).reshape(b, h, w, 3, n_heads, e)
    q, k, v = qkv.unbind(3)
    q, k = norms.scale_for_cosine_sim(q, k, attn_scale[:, None], cos_eps)
    theta = rope.axial_rope_theta(pos, rope.axial_rope_freqs(e // 2, n_heads,
                                                             device=x.device))
    q = rope.apply_rotary_emb(q, theta)
    k = rope.apply_rotary_emb(k, theta)
    return (q.reshape(b, h, w, d), k.reshape(b, h, w, d),
            v.reshape(b, h, w, d))


def reference_backward(x, pos, norm_scale, w_qkv, attn_scale, n_heads, gq,
                       gk, gv, eps=1e-6, cos_eps=1e-6):
    """Plain version of the backward: autograd through ``reference``.
    Returns (dx, d norm_scale, d w_qkv, d attn_scale)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_()
                  for t in (x, norm_scale, w_qkv, attn_scale)]
        out = reference(inputs[0], pos, *inputs[1:], n_heads, eps, cos_eps)
        return torch.autograd.grad(out, inputs, (gq, gk, gv))


def rope_tables(pos, n_heads, d_head):
    """cos and sin of the RoPE angles, (h * w, heads * d_head // 4) float32,
    built from the positions the model passes (the plain version's theta)."""
    theta = rope.axial_rope_theta(
        pos.float(), rope.axial_rope_freqs(d_head // 2, n_heads,
                                           device=pos.device))
    theta = theta.reshape(pos.shape[0] * pos.shape[1], -1)
    return torch.cos(theta).contiguous(), torch.sin(theta).contiguous()


def takes(d, n_heads):
    """Whether K1 and K6 take an attention layer of width d = heads * e: e
    in ``HEAD_DIMS`` and d a multiple of 64. A routing decision made by
    shape before any launch: the HDiT runs the plain prologue on the card
    where it is false (a neighborhood level of head dim 128), as the JAX
    dispatcher computes the prologue outside its Pallas kernel for the
    shapes that kernel does not take."""
    e = d // n_heads
    return e * n_heads == d and e in HEAD_DIMS and d % 64 == 0


def _operands(x, norm_scale, w_qkv, attn_scale, n_heads, strided=False):
    """Checks and casts the operands both kernels share: x bfloat16 or
    float32, norm_scale of x's dtype, ``w_qkv`` cast to it. With
    ``strided`` (the forward), ``norm_scale``'s rows may lie apart.
    Returns (w_qkv, attn_scale, norm_scale's row stride)."""
    b, h, w, d = x.shape
    if not takes(d, n_heads):
        raise ValueError(f"fused_qkv kernel takes head dim 32 or 64 and d a "
                         f"multiple of 64; got d={d} with {n_heads} heads")
    dev, dtype = x.device, x.dtype
    if dtype not in DTYPES:
        raise ValueError(f"fused_qkv kernel: x is {dtype}; the kernels take "
                         f"bfloat16 or float32")
    w_qkv = w_qkv.to(dtype)
    attn_scale = attn_scale.float()
    _build.require(x, "x", dev, dtype, (b, h, w, d))
    if strided:
        scale_stride = _build.require_rows(norm_scale, "norm_scale", dev,
                                           dtype, (b, d))
    else:
        _build.require(norm_scale, "norm_scale", dev, dtype, (b, d))
        scale_stride = d
    _build.require(w_qkv, "w_qkv", dev, dtype, (d, 3 * d))
    _build.require(attn_scale, "attn_scale", dev, torch.float32, (n_heads,))
    return w_qkv, attn_scale, scale_stride


@functools.lru_cache(maxsize=None)
def _freqs(n_heads, d_head, device):
    """The RoPE frequencies (heads, d_head // 8) float32 on ``device``,
    contiguous: fixed, so built once."""
    return rope.axial_rope_freqs(d_head // 2, n_heads, device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index, d, n_heads, step_panels):
    """How many K1 blocks fit on one SM of CUDA device ``index`` at once."""
    lib = _build.load("fused_qkv", kdt_fused_qkv=_SIGNATURE)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        status = lib.kdt_fused_qkv(*[None] * 9, 1, 64, d, n_heads, step_panels,
                                   1, d, 0.0, 0.0, None, ctypes.byref(blocks))
    _build.check_launch(lib, status, "fused_qkv occupancy")
    return blocks.value


def forward_split(images, tokens, d, n_heads, device):
    """K1's grid: (step_panels, groups). A ring step takes two 64-column
    panels of W_qkv where d % 128 == 0 (3d / 64 even) and shared memory
    holds the ring of two-tile stages, else one. A block holds two row
    tiles, and their 3d / (64 step_panels) step units split over
    ``groups`` blocks, as many as make the fewest rounds of resident blocks
    times the steps a block takes on average (kt a unit, and about kt + 2
    for the x tiles and the last stores)."""
    kt = d // 64
    step_panels = 2 if d % 128 == 0 and _build.fits(2 * kt + 3 * 2) else 1
    units = 3 * kt // step_panels
    index = torch.cuda.current_device() if device.index is None else device.index
    slots = _build.sm_count(device) * _blocks_per_sm(index, d, n_heads,
                                                     step_panels)
    blocks = -(-images * -(-tokens // 64) // 2)
    _, groups = _build.best_split(blocks, units, lambda g: slots,
                                  lambda g: units / g * kt + kt + 2)
    return step_panels, groups


def prologue_forward(x, pos, norm_scale, w_qkv, attn_scale, n_heads,
                     eps=1e-6, cos_eps=1e-6):
    """Launches K1 (its float32 form on float32 x) on CUDA tensors: returns
    (q, k, v) in x's dtype. ``norm_scale`` is (b, d) with unit inner
    stride, its rows contiguous or apart."""
    _build.require_cuda(x, "fused_qkv_prologue")
    b, h, w, d = x.shape
    if d > MAX_D and x.dtype != torch.float32:
        raise ValueError(f"fused_qkv forward takes d up to {MAX_D}; got d={d}")
    w_qkv, attn_scale, scale_stride = _operands(
        x, norm_scale, w_qkv, attn_scale, n_heads, strided=True)
    pos = pos.float().contiguous()
    freqs = _freqs(n_heads, d // n_heads, x.device)
    _build.require(pos, "pos", x.device, torch.float32, (h, w, 2))
    q, k, v = (torch.empty_like(x) for _ in range(3))
    global launches, launches_f32
    if x.dtype == torch.float32:
        # scratch: W_qkv^T rounded to TF32, the B operand of the products
        wt = torch.empty((3 * d, d), device=x.device, dtype=torch.float32)
        lib = _build.load("fused_qkv_f32", kdt_fused_qkv_f32=_F32_SIGNATURE)
        _build.launch(
            lib, "kdt_fused_qkv_f32", "fused_qkv", x.device,
            *map(_build.ptr, (x, norm_scale, w_qkv, attn_scale, pos, freqs,
                              q, k, v, wt)),
            b, h * w, d, n_heads, scale_stride, eps, cos_eps,
            _build.stream_ptr(x.device))
        launches_f32 += 1
        return q, k, v
    step_panels, groups = forward_split(b, h * w, d, n_heads, x.device)
    lib = _build.load("fused_qkv", kdt_fused_qkv=_SIGNATURE)
    _build.launch(
        lib, "kdt_fused_qkv", "fused_qkv", x.device,
        *map(_build.ptr, (x, norm_scale, w_qkv, attn_scale, pos, freqs,
                          q, k, v)),
        b, h * w, d, n_heads, step_panels, groups, scale_stride, eps, cos_eps,
        _build.stream_ptr(x.device), None)
    launches += 1
    return q, k, v


def prologue_backward(x, pos, norm_scale, w_qkv, attn_scale, n_heads, gq, gk,
                      gv, eps=1e-6, cos_eps=1e-6):
    """Launches K6 (its float32 form on float32 x) on CUDA tensors: returns
    (dx, d norm_scale, d w_qkv, d attn_scale), each in its input's dtype
    (dx and d norm_scale in x's, the parameter gradients float32)."""
    _build.require_cuda(x, "fused_qkv_prologue backward")
    b, h, w, d = x.shape
    w_cast, scale32, _ = _operands(x, norm_scale, w_qkv, attn_scale,
                                   n_heads)
    if x.dtype == torch.float32:
        return _backward_f32(x, pos, norm_scale, w_cast, scale32, n_heads,
                             gq, gk, gv, eps, cos_eps, attn_scale.dtype)
    cos_t, sin_t = rope_tables(pos, n_heads, d // n_heads)
    _build.require(cos_t, "cos table", x.device, torch.float32,
                   (h * w, d // 4))
    dev, f32 = x.device, torch.float32
    gq, gk, gv = (g.contiguous() for g in (gq, gk, gv))
    for name, g in (("gq", gq), ("gk", gk), ("gv", gv)):
        _build.require(g, name, dev, torch.bfloat16, (b, h, w, d))
    rows, tokens = b * h * w, h * w
    tiles = -(-tokens // 64)
    # the first kernel's column panels in groups; rows per dW partial
    groups = _build.grid_splits(b * tiles, 3 * d // 64, dev)
    chunk_rows = _build.row_chunk(rows, d // 64 * max(1, 3 * d // 128), dev)
    dx = torch.empty_like(x)
    dns = torch.empty((b, d), device=dev, dtype=f32)
    dw = torch.empty((d, 3 * d), device=dev, dtype=f32)
    das_sums = torch.empty(2 * n_heads, device=dev, dtype=f32)
    dqk = torch.empty((rows, 2 * d), device=dev, dtype=torch.bfloat16)
    xn = torch.empty_like(x)
    r = torch.empty(rows, device=dev, dtype=f32)
    dot_part = torch.empty((groups, rows), device=dev, dtype=f32)
    das_part = torch.empty((b * tiles, 2 * n_heads), device=dev, dtype=f32)
    dns_part = torch.empty((b * tiles, d), device=dev, dtype=f32)
    dw_part = torch.empty((-(-rows // chunk_rows), d, 3 * d), device=dev,
                          dtype=f32)
    lib = _build.load("fused_qkv", kdt_fused_qkv_bwd=_BWD_SIGNATURE)
    _build.launch(
        lib, "kdt_fused_qkv_bwd", "fused_qkv backward", dev,
        *map(_build.ptr, (x, norm_scale, w_cast, scale32, cos_t, sin_t, gq,
                          gk, gv, dx, dns, dw, das_sums, dqk, xn, r,
                          dot_part, das_part, dns_part, dw_part)),
        b, tokens, d, n_heads, groups, chunk_rows, eps, cos_eps,
        _build.stream_ptr(dev))
    global bwd_launches
    bwd_launches += 1
    das = (das_sums[:n_heads] + das_sums[n_heads:]) / (2 * scale32)
    return (dx, dns.to(norm_scale.dtype), dw.to(w_qkv.dtype),
            das.to(attn_scale.dtype))


def backward_f32_scratch(images, tokens, d, n_heads, sms):
    """K6-f32's scratch as ``kdt_fused_qkv_bwd_f32`` takes it: name -> shape
    (float32), and (tiles, ld, chunk_rows). W_qkv^T and W_qkv rounded to
    TF32, dR^T at row pitch ld (q, k, then v's part, gv), xn, r, the
    per-panel dot partials, the per-tile d(attn_scale) and d(scale)
    partials and the split-K partials of dW_qkv = xn^T dR."""
    rows, tiles = images * tokens, -(-tokens // _build.F32_ROWS)
    ld = _build.f32_pitch(rows)
    chunk_rows = _build.f32_weight_chunks(rows, d, 3 * d, sms)
    shapes = {"wt": (3 * d, d), "w_r": (d, 3 * d), "drt": (3 * d, ld),
              "xn": (rows, d), "r": (rows,), "dot_part": (3 * d // 64, rows),
              "das_part": (images * tiles, 2 * n_heads),
              "dns_part": (images * tiles, d),
              "dw_part": (-(-rows // chunk_rows), d, 3 * d)}
    return shapes, (tiles, ld, chunk_rows)


def _backward_f32(x, pos, norm_scale, w_qkv, scale32, n_heads, gq, gk, gv,
                  eps, cos_eps, scale_dtype):
    """K6's float32 form on checked float32 operands (``w_qkv`` and
    ``scale32`` as ``_operands`` returns them)."""
    b, h, w, d = x.shape
    dev, f32 = x.device, torch.float32
    pos = pos.float().contiguous()
    _build.require(pos, "pos", dev, f32, (h, w, 2))
    freqs = _freqs(n_heads, d // n_heads, dev)
    gq, gk, gv = (g.contiguous() for g in (gq, gk, gv))
    for name, g in (("gq", gq), ("gk", gk), ("gv", gv)):
        _build.require(g, name, dev, f32, (b, h, w, d))
    shapes, (tiles, ld, chunk_rows) = backward_f32_scratch(
        b, h * w, d, n_heads, _build.sm_count(dev))
    scratch = [torch.empty(shape, device=dev, dtype=f32)
               for shape in shapes.values()]
    dx = torch.empty_like(x)
    dns = torch.empty((b, d), device=dev, dtype=f32)
    dw = torch.empty((d, 3 * d), device=dev, dtype=f32)
    das_sums = torch.empty(2 * n_heads, device=dev, dtype=f32)
    lib = _build.load("fused_qkv_f32",
                      kdt_fused_qkv_bwd_f32=_F32_BWD_SIGNATURE)
    _build.launch(
        lib, "kdt_fused_qkv_bwd_f32", "fused_qkv backward", dev,
        *map(_build.ptr, (x, norm_scale, w_qkv, scale32, pos, freqs, gq, gk,
                          gv, dx, dns, dw, das_sums, *scratch)),
        b, h * w, tiles, d, n_heads, ld, chunk_rows, eps, cos_eps,
        _build.stream_ptr(dev))
    global bwd_launches_f32
    bwd_launches_f32 += 1
    das = (das_sums[:n_heads] + das_sums[n_heads:]) / (2 * scale32)
    return dx, dns, dw, das.to(scale_dtype)


class _Prologue(torch.autograd.Function):
    """K1 forward, K6 backward. Saves only the primal inputs: the backward
    recomputes the projection, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, x, pos, norm_scale, w_qkv, attn_scale, n_heads, eps,
                cos_eps):
        ctx.save_for_backward(x, pos, norm_scale, w_qkv, attn_scale)
        ctx.static = (n_heads, eps, cos_eps)
        return prologue_forward(x, pos, norm_scale, w_qkv, attn_scale,
                                n_heads, eps, cos_eps)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, pos, norm_scale, w_qkv, attn_scale = ctx.saved_tensors
        n_heads, eps, cos_eps = ctx.static
        dx, dns, dw, das = prologue_backward(
            x, pos, norm_scale, w_qkv, attn_scale, n_heads, gq, gk, gv, eps,
            cos_eps)
        return dx, None, dns, dw, das, None, None, None


def fused_qkv_prologue(x, pos, norm_scale, w_qkv, attn_scale, n_heads,
                       eps=1e-6, cos_eps=1e-6):
    """Returns (q, k, v), each (b, h, w, d), with cosine-sim scaling and RoPE
    applied to q and k; differentiable. The kernels take bfloat16 or float32
    x and norm_scale of x's dtype, head dim 32 or 64 and d % 64 == 0
    (``takes``), and a CUDA tensor of another shape raises: a model routes
    the head dims they do not take to the plain prologue before calling
    (the HDiT's neighborhood levels of head dim 128); ``w_qkv`` is cast to
    x's dtype, as the JAX dispatcher does.
    ``norm_scale`` may be a (b, d) column block of a wider matrix (a
    condcache row) only where autograd is off: the backward kernel takes a
    contiguous scale."""
    if torch.is_grad_enabled() and not norm_scale.is_contiguous():
        raise ValueError("a strided norm_scale (a condcache row's block) is "
                         "forward-only: run under torch.no_grad()")
    if x.device.type == "cpu":
        return reference(x, pos, norm_scale, w_qkv, attn_scale, n_heads, eps,
                         cos_eps)
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return prologue_forward(x, pos, norm_scale, w_qkv, attn_scale,
                                n_heads, eps, cos_eps)
    return _Prologue.apply(x, pos, norm_scale, w_qkv, attn_scale, n_heads,
                           eps, cos_eps)
