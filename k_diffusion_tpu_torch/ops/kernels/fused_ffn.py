"""K4 and K10: the fused AdaRMSNorm + GEGLU feed-forward block and its
backward (counterpart of k_diffusion_tpu/ops/pallas/fused_ffn.py).

``x + down(GEGLU(up(AdaRMSNorm(x, scale))))``. On CUDA tensors the forward
is two launches of the kernels in ``csrc/geglu.cu``: norm -> up -> GEGLU
writes the bfloat16 hidden activation, then down + residual reads it back.
The backward, through an autograd Function, is the kernel K10 of the same
file. CPU tensors go to ``reference``, the plain version, which autograd
differentiates.
"""

import ctypes

import torch

from ..geglu import linear_geglu
from ..norms import rms_norm
from . import _build

launches = 0      # forward wrapper calls that launched the kernels
bwd_launches = 0  # backward wrapper calls that launched the kernels

_P = ctypes.c_void_p
# x, scale, w_up, h, rows, tokens, d, d_ff, eps, stream
_UP = [_P] * 4 + [ctypes.c_long] + [ctypes.c_int] * 3 + [ctypes.c_float, _P]
# h, w_down, x, out, rows, d, d_ff, stream
_DOWN = [_P] * 4 + [ctypes.c_long] + [ctypes.c_int] * 2 + [_P]
# x, scale, w_up, w_down, g, dx, dscale, dw_up, dw_down, h, dup, xn, r,
# dot_part, dns_part, dw_part, images, tokens, d, d_ff, groups, chunk_up,
# chunk_down, eps, stream
_BWD = [_P] * 16 + [ctypes.c_int] * 7 + [ctypes.c_float, _P]


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


def _operands(x, scale, w_up, w_down):
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    if d % 64 or d_ff % 64:
        raise ValueError(f"fused_ffn kernels take d and d_ff multiples of 64; "
                         f"got d={d}, d_ff={d_ff}")
    dev, bf16 = x.device, torch.bfloat16
    w_up, w_down = w_up.to(bf16), w_down.to(bf16)
    _build.require(x, "x", dev, bf16, (b, t, d))
    _build.require(scale, "scale", dev, bf16, (b, d))
    _build.require(w_up, "w_up", dev, bf16, (d, 2 * d_ff))
    _build.require(w_down, "w_down", dev, bf16, (d_ff, d))
    return w_up, w_down


def ffn_forward(x, scale, w_up, w_down, eps=1e-6):
    """Launches K4 on CUDA tensors: returns x + FFN(norm(x))."""
    _build.require_cuda(x, "fused_geglu_ffn")
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    w_up, w_down = _operands(x, scale, w_up, w_down)
    hidden = torch.empty((b, t, d_ff), device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    lib = _build.load("geglu", kdt_ffn_up=_UP, kdt_ffn_down=_DOWN)
    stream = _build.stream_ptr(x.device)
    status = lib.kdt_ffn_up(*map(_build.ptr, (x, scale, w_up, hidden)),
                            b * t, t, d, d_ff, eps, stream)
    _build.check_launch(lib, status, "fused_ffn up")
    status = lib.kdt_ffn_down(*map(_build.ptr, (hidden, w_down, x, out)),
                              b * t, d, d_ff, stream)
    _build.check_launch(lib, status, "fused_ffn down")
    global launches
    launches += 1
    return out


def ffn_backward(x, scale, w_up, w_down, g, eps=1e-6):
    """Launches K10 on CUDA tensors: returns (dx, d scale, d w_up,
    d w_down), each in its input's dtype (dx, d scale bf16; the weight
    gradients float32)."""
    _build.require_cuda(x, "fused_geglu_ffn backward")
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    w16_up, w16_down = _operands(x, scale, w_up, w_down)
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
    status = lib.kdt_ffn_bwd(
        *map(_build.ptr, (x, scale, w16_up, w16_down, g, dx, dscale, dw_up,
                          dw_down, h, dup, xn, r, dot_part, dns_part,
                          dw_part)),
        b, t, d, d_ff, groups, chunk_up, chunk_down, eps,
        _build.stream_ptr(dev))
    _build.check_launch(lib, status, "fused_ffn backward")
    global bwd_launches
    bwd_launches += 1
    return (dx, dscale.to(scale.dtype), dw_up.to(w_up.dtype),
            dw_down.to(w_down.dtype))


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
    differentiable. The kernels take bfloat16 x and scale with d and d_ff
    multiples of 64; the weights are cast to x's dtype, as the JAX
    dispatcher does."""
    if x.device.type == "cpu":
        return reference(x, scale, w_up, w_down, eps)
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return ffn_forward(x, scale, w_up, w_down, eps)
    return _FFN.apply(x, scale, w_up, w_down, eps)
