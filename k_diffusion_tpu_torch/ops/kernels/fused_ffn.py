"""K4 and K10: the fused AdaRMSNorm + GEGLU feed-forward block and its
backward (counterpart of k_diffusion_tpu/ops/pallas/fused_ffn.py).

``x + down(GEGLU(up(AdaRMSNorm(x, scale))))``. On CUDA tensors the forward
is one launch of ``ffn_fwd_kernel`` in ``csrc/geglu.cu``: norm -> up ->
GEGLU -> down -> + x, the bfloat16 hidden activation kept in registers. The
backward, through an autograd Function, is the kernel K10 of the same file.
CPU tensors go to ``reference``, the plain version, which autograd
differentiates.

The forward reads each image's scale through a row stride, so that
``scale`` may be a (b, d) column block of a condcache row (the JAX
kernel's BlockSpec lane block, ``scale_block``): no copy is made. That path
is forward-only; the backward K10 takes a contiguous scale.

bfloat16 operands go to those kernels, float32 operands (a model built
with ``dtype=torch.float32``, ``--mixed-precision no``) to their float32
forms in ``csrc/geglu_f32.cu``: the same contract, products on the TF32
tensor cores with f32 accumulation, any d and d_ff multiples of 64, all on
the TF32 ``wgmma`` core ``csrc/gemm_tf32_wg.cuh`` after passes that copy
the weights rounded to TF32 into scratch. The float32 forward is routed by
width before any launch (``f32_route``): at d in ``ONE_LAUNCH_F32`` (64,
128, 256, 512: every shipped width but 768) ``kdt_ffn_fwd_f32``, one
launch of ``ffn_f32_fwd_kernel`` with h in registers; at any other width
``kdt_ffn_fwd_f32_wide``, two kernels with h rounded to TF32 through
device memory (its scratch allocated on that route only). The backward
``kdt_ffn_bwd_f32``. Each dtype's launches are counted apart, one a
wrapper call.
"""

import ctypes
import functools

import torch

from ..geglu import linear_geglu
from ..norms import rms_norm
from . import _build

launches = 0      # forward wrapper calls that launched the kernels, bf16
bwd_launches = 0  # backward wrapper calls that launched the kernels, bf16
launches_f32 = 0      # forward wrapper calls on float32 operands
wide_launches_f32 = 0  # of those, the ones on the wide route (f32_route)
bwd_launches_f32 = 0  # backward wrapper calls on float32 operands

DTYPES = (torch.bfloat16, torch.float32)  # x dtypes the kernels take

_P = ctypes.c_void_p
# x, scale, w_up, w_down, out, images, tokens, d, d_ff, warpgroups,
# out_tiles, groups, scale_stride, eps, stream, clusters (int *: the
# occupancy query)
_FWD = [_P] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, _P, _P]
# the widest d the forward takes: its x tiles, h tiles and ring in one
# block's shared memory
MAX_D = 896
# the widest d the backward takes: its first kernel's 2 d / 64 resident
# tiles (xn and g) and 3-stage ring of 3 tiles in one block's shared memory
MAX_BWD_D = 576
# x, scale, w_up, w_down, g, dx, dscale, dw_up, dw_down, h, dup, xn, r,
# dot_part, dns_part, dw_part, images, tokens, d, d_ff, groups, chunk_up,
# chunk_down, eps, stream
_BWD = [_P] * 16 + [ctypes.c_int] * 7 + [ctypes.c_float, _P]
# the float32 forms: x, scale, w_up, w_down, out, w_upt, w_downt, images,
# tokens, d, d_ff, groups, scale_stride, eps, stream, clusters (int *: the
# occupancy query)
_F32_FWD = [_P] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, _P, _P]
# the wide route: x, scale, w_up, w_down, out, w_upt, w_downt, h, images,
# tokens, d, d_ff, scale_stride, eps, stream
_F32_FWD_WIDE = [_P] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
# the widths the float32 forward takes in one launch, h in registers: a
# block's output tiles in at most 128 registers a thread (at d = 512 two
# blocks of a cluster own 256 columns each) and, at d <= 256, the resident
# x tile in its shared memory
ONE_LAUNCH_F32 = (64, 128, 256, 512)
# x, scale, w_up, w_down, g, dx, dscale, dw_up, dw_down, w_upt, w_up_r,
# w_down_r, ht, dupt, xn, r, dot_part, dns_part, dw_part, images, tokens,
# tiles, d, d_ff, ld, chunk_up, chunk_down, eps, stream
_F32_BWD = [_P] * 19 + [ctypes.c_int] * 5 + [ctypes.c_long] * 3 + [
    ctypes.c_float, _P]


def reference(x, scale, w_up, w_down, eps=1e-6):
    """Plain version. x (b, t, d); scale (b, d); w_up (d, 2 d_ff);
    w_down (d_ff, d)."""
    xn = rms_norm(x, scale[:, None, :], eps)
    return x + linear_geglu(xn, w_up.to(x.dtype)) @ w_down.to(x.dtype)


def reference_backward(x, scale, w_up, w_down, g, eps=1e-6):
    """Plain version of the backward: autograd through ``reference``.
    Returns (dx, d scale, d w_up, d w_down)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, scale, w_up, w_down)]
        return torch.autograd.grad(reference(*inputs, eps), inputs, g)


def _operands(x, scale, w_up, w_down, strided=False):
    """Checks and casts the operands both kernels share: x bfloat16 or
    float32, scale of x's dtype, the weights cast to it. With ``strided``
    (the forward), ``scale``'s rows may lie apart. Returns (w_up, w_down,
    scale's row stride)."""
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    if d % 64 or d_ff % 64:
        raise ValueError(f"fused_ffn kernels take d and d_ff multiples of 64; "
                         f"got d={d}, d_ff={d_ff}")
    dev, dtype = x.device, x.dtype
    if dtype not in DTYPES:
        raise ValueError(f"fused_ffn kernel: x is {dtype}; the kernels take "
                         f"bfloat16 or float32")
    w_up, w_down = w_up.to(dtype), w_down.to(dtype)
    _build.require(x, "x", dev, dtype, (b, t, d))
    if strided:
        scale_stride = _build.require_rows(scale, "scale", dev, dtype, (b, d))
    else:
        _build.require(scale, "scale", dev, dtype, (b, d))
        scale_stride = d
    _build.require(w_up, "w_up", dev, dtype, (d, 2 * d_ff))
    _build.require(w_down, "w_down", dev, dtype, (d_ff, d))
    return w_up, w_down, scale_stride


@functools.lru_cache(maxsize=None)
def _clusters(index, d, d_ff, warpgroups, out_tiles, groups):
    """How many K4 clusters of ``groups`` blocks fit on CUDA device
    ``index`` at once."""
    lib = _build.load("geglu", kdt_ffn_fwd=_FWD)
    clusters = ctypes.c_int(0)
    with torch.cuda.device(index):
        status = lib.kdt_ffn_fwd(*[None] * 5, 1, 64, d, d_ff, warpgroups,
                                 out_tiles, groups, d, 0.0, None,
                                 ctypes.byref(clusters))
    _build.check_launch(lib, status, "fused_ffn occupancy")
    return clusters.value


def forward_split(images, tokens, d, d_ff, device):
    """K4's grid: (warpgroups, out_tiles, groups). A block is one
    warpgroup holding every output tile where d / 64 is 1, 2 or 4 (or one
    tile where it is odd), else two warpgroups holding out_tiles 64-column
    tiles, half each (the most of 8, 6, 2 that divide d / 64: the register
    budget). The hidden panels, one a warpgroup a round, split over
    clusters of ``groups`` blocks (at most 8), as many as make the fewest
    rounds of resident clusters times the steps a block takes on average
    (kt and the down steps a round, and about kt + 4 for the x tiles and
    the partials)."""
    kt, panels = d // 64, d_ff // 64
    if kt in (1, 2, 4) or kt % 2:
        warpgroups, out_tiles = 1, kt if kt in (1, 2, 4) else 1
    else:
        warpgroups = 2
        out_tiles = next(n for n in (8, 6, 2) if kt % n == 0)
    # one warpgroup takes two output tiles a down step, two one each
    down = -(-out_tiles // 2) if warpgroups == 1 else out_tiles // 2
    index = torch.cuda.current_device() if device.index is None else device.index
    blocks = images * -(-tokens // 64) * (kt // out_tiles)
    _, groups = _build.best_split(
        blocks, min(8, panels),
        lambda g: _clusters(index, d, d_ff, warpgroups, out_tiles, g) * g,
        lambda g: panels / g / warpgroups * (kt + down) + kt + 4)
    return warpgroups, out_tiles, groups


@functools.lru_cache(maxsize=None)
def _clusters_f32(index, d, d_ff, groups):
    """How many float32 K4 clusters of ``groups`` blocks fit on CUDA
    device ``index`` at once."""
    lib = _build.load("geglu_f32", kdt_ffn_fwd_f32=_F32_FWD)
    clusters = ctypes.c_int(0)
    with torch.cuda.device(index):
        status = lib.kdt_ffn_fwd_f32(*[None] * 7, 1, 64, d, d_ff, groups, d,
                                     0.0, None, ctypes.byref(clusters))
    _build.check_launch(lib, status, "fused_ffn float32 occupancy")
    return clusters.value


def f32_units(d):
    """The hidden units of a panel of the one-launch float32 K4
    (``FfnPlan::NU`` in ``csrc/geglu_f32.cu``): 64, or 32 at d >= 256, where
    a block's output tiles take 128 registers a thread."""
    return 32 if d >= 256 else 64


def f32_route(d):
    """The float32 forward's route, chosen by width before any launch:
    "one" (``kdt_ffn_fwd_f32``) at d in ``ONE_LAUNCH_F32``, else "wide"
    (``kdt_ffn_fwd_f32_wide``)."""
    return "one" if d in ONE_LAUNCH_F32 else "wide"


def forward_split_f32(images, tokens, d, d_ff, device):
    """The one-launch float32 K4's cluster size G: a block owns a 128-row
    tile and NO = min(d, 256) output columns, the hidden panels (NU = 64
    units, 32 at d >= 256) split over clusters of G blocks (at most 8), as
    many as make the fewest rounds of resident clusters times the steps a
    block takes (d / 32 up steps a panel and its down steps, about d / 32
    + 4 for the x tile and the partials). At d = 512 a cluster holds both
    column slabs of its row tile, 2 G blocks (G at most 4), each forming h
    of half the panels."""
    units = f32_units(d)
    out_cols = min(d, 256)
    pair = d > out_cols
    panels, kt = d_ff // units, d // 32
    down = units // 32 * (out_cols // min(out_cols, 128))
    index = torch.cuda.current_device() if device.index is None else device.index
    blocks = images * -(-tokens // _build.F32_ROWS) * (d // out_cols)
    _, groups = _build.best_split(
        blocks, min(4 if pair else 8, panels),
        lambda g: _clusters_f32(index, d, d_ff, g) * (2 * g if pair else g),
        lambda g: -(-panels // g) * (kt / (2 if pair else 1) + down) + kt + 4)
    return groups


def forward_f32_scratch(d, d_ff, rows):
    """The float32 forward's scratch, name -> shape (float32), by route:
    W_up^T and W_down^T rounded to TF32 on both, and h (rows, d_ff) on the
    wide route."""
    shapes = {"w_upt": (2 * d_ff, d), "w_downt": (d, d_ff)}
    if f32_route(d) == "wide":
        shapes["h"] = (rows, d_ff)
    return shapes


def ffn_forward(x, scale, w_up, w_down, eps=1e-6):
    """Launches K4 (its float32 form on float32 x) on CUDA tensors: returns
    x + FFN(norm(x)). ``scale`` is (b, d) with unit inner stride, its rows
    contiguous or apart."""
    _build.require_cuda(x, "fused_geglu_ffn")
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    if d > MAX_D and x.dtype != torch.float32:
        raise ValueError(f"fused_ffn forward takes d up to {MAX_D}; got d={d}")
    w_up, w_down, scale_stride = _operands(x, scale, w_up, w_down,
                                           strided=True)
    out = torch.empty_like(x)
    global launches, launches_f32
    if x.dtype == torch.float32:
        scratch = [torch.empty(shape, device=x.device, dtype=torch.float32)
                   for shape in forward_f32_scratch(d, d_ff, b * t).values()]
        tensors = map(_build.ptr, (x, scale, w_up, w_down, out, *scratch))
        if f32_route(d) == "one":
            groups = forward_split_f32(b, t, d, d_ff, x.device)
            lib = _build.load("geglu_f32", kdt_ffn_fwd_f32=_F32_FWD)
            _build.launch(
                lib, "kdt_ffn_fwd_f32", "fused_ffn", x.device, *tensors, b, t,
                d, d_ff, groups, scale_stride, eps,
                _build.stream_ptr(x.device), None)
        else:
            lib = _build.load("geglu_f32", kdt_ffn_fwd_f32_wide=_F32_FWD_WIDE)
            _build.launch(
                lib, "kdt_ffn_fwd_f32_wide", "fused_ffn", x.device, *tensors,
                b, t, d, d_ff, scale_stride, eps, _build.stream_ptr(x.device))
            global wide_launches_f32
            wide_launches_f32 += 1
        launches_f32 += 1
        return out
    warpgroups, out_tiles, groups = forward_split(b, t, d, d_ff, x.device)
    lib = _build.load("geglu", kdt_ffn_fwd=_FWD)
    _build.launch(
        lib, "kdt_ffn_fwd", "fused_ffn", x.device,
        *map(_build.ptr, (x, scale, w_up, w_down, out)), b, t, d, d_ff,
        warpgroups, out_tiles, groups, scale_stride, eps,
        _build.stream_ptr(x.device), None)
    launches += 1
    return out


def ffn_backward(x, scale, w_up, w_down, g, eps=1e-6):
    """Launches K10 (its float32 form on float32 x) on CUDA tensors: returns
    (dx, d scale, d w_up, d w_down), each in its input's dtype (dx, d scale
    in x's; the weight gradients float32)."""
    _build.require_cuda(x, "fused_geglu_ffn backward")
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    if x.dtype == torch.float32:
        return _backward_f32(x, scale, w_up, w_down, g, eps)
    if d > MAX_BWD_D:
        raise ValueError(f"fused_ffn backward takes d up to {MAX_BWD_D}; "
                         f"got d={d}")
    w16_up, w16_down, _ = _operands(x, scale, w_up, w_down)
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    g = g.contiguous()
    _build.require(g, "g", dev, bf16, (b, t, d))
    rows, tiles = b * t, -(-t // 64)
    # the first kernel's hidden panels in groups; rows per dW partial
    groups = _build.grid_splits(b * tiles, d_ff // 64, dev)
    chunk_up = _build.row_chunk(rows, d // 64 * (d_ff // 64), dev)
    chunk_down = _build.row_chunk(rows, d_ff // 64 * max(1, d // 128), dev)
    part = max(-(-rows // chunk_up), -(-rows // chunk_down)) * 2 * d * d_ff
    dx = torch.empty_like(x)
    dscale = torch.empty((b, d), device=dev, dtype=f32)
    dw_up = torch.empty((d, 2 * d_ff), device=dev, dtype=f32)
    dw_down = torch.empty((d_ff, d), device=dev, dtype=f32)
    h = torch.empty((rows, d_ff), device=dev, dtype=bf16)
    dup = torch.empty((rows, 2 * d_ff), device=dev, dtype=bf16)
    xn = torch.empty_like(x)
    r = torch.empty(rows, device=dev, dtype=f32)
    dot_part = torch.empty((groups, rows), device=dev, dtype=f32)
    dns_part = torch.empty((b * tiles, d), device=dev, dtype=f32)
    dw_part = torch.empty(part, device=dev, dtype=f32)
    lib = _build.load("geglu", kdt_ffn_bwd=_BWD)
    _build.launch(
        lib, "kdt_ffn_bwd", "fused_ffn backward", dev,
        *map(_build.ptr, (x, scale, w16_up, w16_down, g, dx, dscale, dw_up,
                          dw_down, h, dup, xn, r, dot_part, dns_part,
                          dw_part)),
        b, t, d, d_ff, groups, chunk_up, chunk_down, eps,
        _build.stream_ptr(dev))
    global bwd_launches
    bwd_launches += 1
    return (dx, dscale.to(scale.dtype), dw_up.to(w_up.dtype),
            dw_down.to(w_down.dtype))


def backward_f32_scratch(images, tokens, d, d_ff, sms):
    """K10-f32's scratch as ``kdt_ffn_bwd_f32`` takes it: name -> shape
    (float32), and (tiles, ld, chunk_up, chunk_down). The weights rounded
    to TF32 (W_up^T, W_up, W_down), h^T and dup^T at row pitch ld, xn, r,
    the per-panel dot partials, the per-tile d(scale) partials and the
    split-K partials of dW_up = xn^T dup and dW_down^T = g^T h, which share
    one buffer."""
    rows, tiles = images * tokens, -(-tokens // _build.F32_ROWS)
    ld = _build.f32_pitch(rows)
    chunk_up = _build.f32_weight_chunks(rows, d, 2 * d_ff, sms)
    chunk_down = _build.f32_weight_chunks(rows, d, d_ff, sms)
    part = max(-(-rows // chunk_up) * 2, -(-rows // chunk_down)) * d * d_ff
    shapes = {"w_upt": (2 * d_ff, d), "w_up_r": (d, 2 * d_ff),
              "w_down_r": (d_ff, d), "ht": (d_ff, ld), "dupt": (2 * d_ff, ld),
              "xn": (rows, d), "r": (rows,), "dot_part": (d_ff // 64, rows),
              "dns_part": (images * tiles, d), "dw_part": (part,)}
    return shapes, (tiles, ld, chunk_up, chunk_down)


def _backward_f32(x, scale, w_up, w_down, g, eps):
    """K10's float32 form on CUDA tensors."""
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    w32_up, w32_down, _ = _operands(x, scale, w_up, w_down)
    dev, f32 = x.device, torch.float32
    g = g.contiguous()
    _build.require(g, "g", dev, f32, (b, t, d))
    shapes, (tiles, ld, chunk_up, chunk_down) = backward_f32_scratch(
        b, t, d, d_ff, _build.sm_count(dev))
    scratch = [torch.empty(shape, device=dev, dtype=f32)
               for shape in shapes.values()]
    dx = torch.empty_like(x)
    dscale = torch.empty((b, d), device=dev, dtype=f32)
    dw_up = torch.empty((d, 2 * d_ff), device=dev, dtype=f32)
    dw_down = torch.empty((d_ff, d), device=dev, dtype=f32)
    lib = _build.load("geglu_f32", kdt_ffn_bwd_f32=_F32_BWD)
    _build.launch(
        lib, "kdt_ffn_bwd_f32", "fused_ffn backward", dev,
        *map(_build.ptr, (x, scale, w32_up, w32_down, g, dx, dscale, dw_up,
                          dw_down, *scratch)),
        b, t, tiles, d, d_ff, ld, chunk_up, chunk_down, eps,
        _build.stream_ptr(dev))
    global bwd_launches_f32
    bwd_launches_f32 += 1
    return dx, dscale, dw_up.to(w_up.dtype), dw_down.to(w_down.dtype)


class _FFN(torch.autograd.Function):
    """K4 forward, K10 backward. Saves only the primal inputs: the backward
    recomputes the up projection, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, x, scale, w_up, w_down, eps):
        ctx.save_for_backward(x, scale, w_up, w_down)
        ctx.eps = eps
        return ffn_forward(x, scale, w_up, w_down, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, w_up, w_down = ctx.saved_tensors
        return (*ffn_backward(x, scale, w_up, w_down, g, ctx.eps), None)


def fused_geglu_ffn(x, scale, w_up, w_down, eps=1e-6):
    """x (b, t, d); scale (b, d) = AdaRMSNorm proj(cond) + 1; w_up
    (d, 2 d_ff); w_down (d_ff, d). Returns x + FFN(norm(x));
    differentiable. The kernels take bfloat16 or float32 x and scale of x's
    dtype with d and d_ff multiples of 64; the weights are cast to x's
    dtype, as the JAX dispatcher does. ``scale`` may be a (b, d) column
    block of a wider matrix (a condcache row) only where autograd is off:
    the backward kernel takes a contiguous scale."""
    if torch.is_grad_enabled() and not scale.is_contiguous():
        raise ValueError("a strided scale (a condcache row's block) is "
                         "forward-only: run under torch.no_grad()")
    if x.device.type == "cpu":
        return reference(x, scale, w_up, w_down, eps)
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return ffn_forward(x, scale, w_up, w_down, eps)
    return _FFN.apply(x, scale, w_up, w_down, eps)
