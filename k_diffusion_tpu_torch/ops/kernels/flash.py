"""K13 and K14: exact global attention on (b, s, heads, e) q, k, v and its
backward (counterpart of k_diffusion_tpu/ops/pallas/flash.py).

CUDA tensors go to the hand-written kernels in ``csrc/flash.cu`` through an
autograd Function: the forward K13 (which also writes the per-head
logsumexp when a backward follows), the wgmma kernel of ``csrc/attn_fwd.cuh``
that K3 shares, and the backward K14, the wgmma kernels of
``csrc/attn_bwd.cuh`` that K9 shares (a dq kernel, which also computes
delta = rowsum(out * dout), and a dk/dv kernel, counted as one launch);
the Function saves q, k, v, the output and the logsumexp, as the JAX
custom_vjp does, and under a remat policy keeps them (``residuals``).
With autograd off, as in sampling, the wrapper calls K13 directly. CPU
tensors go to ``reference``, the plain version, which autograd
differentiates; ``reference_lse`` is the plain version of K13's logsumexp.

The kernels read q, k and v through their batch and sequence strides, so
the U-Net's q, k, v, strided views of one qkv projection, are not copied;
the head axis must be packed at the head dim and the head dim contiguous.

bfloat16 operands go to those wgmma kernels, float32 operands (a model
built with ``dtype=torch.float32``, ``--mixed-precision no``) to their
float32 forms in ``csrc/attn_tf32.cuh`` (``kdt_flash_fwd_f32``,
``kdt_flash_bwd_f32``): the same contract, products on the TF32 tensor
cores with f32 accumulation. Each dtype's launches are counted apart.
"""

import ctypes
import functools

import torch

from ..attention import global_attention, global_logsumexp
from . import _build, residuals

launches = 0      # K13 launches since the last reset, bfloat16
bwd_launches = 0  # K14 launches (its two kernels count as one), bfloat16
launches_f32 = 0      # K13 launches on float32 operands
bwd_launches_f32 = 0  # K14 launches on float32 operands

DTYPES = (torch.bfloat16, torch.float32)  # operand dtypes the kernels take

HEAD_DIMS = (32, 64)  # head dims the kernels take

_P = ctypes.c_void_p
_L = ctypes.c_long
# q, k, v, out, lse, batch, seq, heads, head dim, stride_b, stride_s,
# scale, stream
_SIGNATURE = [_P] * 5 + [ctypes.c_int] * 4 + [_L] * 2 + [ctypes.c_float, _P]
# q, k, v, out, dout, lse, delta, dq, dk, dv, batch, seq, heads, head dim,
# stride_b, stride_s, scale, stream
_BWD_SIGNATURE = [_P] * 10 + [ctypes.c_int] * 4 + [_L] * 2 + [ctypes.c_float,
                                                                 _P]


def reference(q, k, v, scale=1.0):
    """Plain version: softmax attention, q/k/v (b, s, heads, e)."""
    return global_attention(q, k, v, scale)


def reference_lse(q, k, v, scale=1.0):
    """Plain version of K13's logsumexp: log sum exp of each query's scaled
    logits, in float32 and natural log, (b, heads, s) from q/k/v (b, s,
    heads, e); v is not read."""
    return global_logsumexp(q, k, scale)


def reference_backward(q, k, v, dout, scale=1.0):
    """Plain version of the backward: autograd through ``reference``.
    Returns (dq, dk, dv)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = reference(*inputs, scale)
        return torch.autograd.grad(out, inputs, dout)


def _check(q, k, v, what):
    """Raises unless q, k, v are as the kernels take them: CUDA tensors of
    one dtype, bfloat16 or float32, and one shape (b, s, heads, e), e in
    HEAD_DIMS, with the same strides, the head axis packed and the head dim
    contiguous, 16-byte aligned rows (strides multiples of 8 bfloat16 or 4
    float32 elements). Returns the dtype."""
    _build.require_cuda(q, what)
    b, s, heads, e = q.shape
    if e not in HEAD_DIMS or s < 1:
        raise ValueError(f"flash kernel takes head dim 32 or 64 and s >= 1; "
                         f"got q of shape {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{what}: q is {q.dtype}; the kernels take "
                         f"bfloat16 or float32")
    per_row = 16 // q.element_size()  # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"{what}: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                f"the kernel takes q's {q.dtype} {tuple(q.shape)} on "
                f"{q.device}")
        if not (t.stride() == q.stride() and t.stride()[2:] == (e, 1)
                and t.stride(0) % per_row == 0 and t.stride(1) % per_row == 0
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"{what}: {name} has strides {t.stride()} at offset "
                f"{t.data_ptr() % 16} mod 16 bytes; the kernel takes q, k, v "
                f"of equal strides (x, y, {e}, 1), x and y multiples of "
                f"{per_row} ({q.dtype}), 16-byte aligned (q's are "
                f"{q.stride()})")
    return q.dtype


def flash_forward(q, k, v, scale=1.0, save_lse=False):
    """Launches K13 (its float32 form on float32 operands) on CUDA tensors.
    Returns (out, lse): out (b, s, heads, e) in q's dtype, contiguous, lse
    (b, heads, s) float32, or None unless ``save_lse``."""
    dtype = _check(q, k, v, "flash_attention")
    b, s, heads, e = q.shape
    out = torch.empty((b, s, heads, e), device=q.device, dtype=q.dtype)
    lse = (torch.empty((b, heads, s), device=q.device, dtype=torch.float32)
           if save_lse else None)
    lib = _build.load("flash", kdt_flash_fwd=_SIGNATURE,
                      kdt_flash_fwd_f32=_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out)),
            None if lse is None else _build.ptr(lse), b, s, heads, e,
            q.stride(0), q.stride(1), scale, _build.stream_ptr(q.device))
    global launches, launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_flash_fwd_f32", "flash", q.device, *args)
        launches_f32 += 1
    else:
        _build.launch(lib, "kdt_flash_fwd", "flash", q.device, *args)
        launches += 1
    return out, lse


def flash_backward(q, k, v, out, lse, dout, scale=1.0):
    """Launches K14 (its float32 form on float32 operands) on CUDA tensors:
    returns (dq, dk, dv) in q's dtype, each (b, s, heads, e) contiguous.
    Its dq kernel computes delta = rowsum(out * dout) into scratch for the
    dk/dv kernel (the JAX package computes it outside its kernels)."""
    dtype = _check(q, k, v, "flash_attention backward")
    b, s, heads, e = q.shape
    dev = q.device
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        _build.require(t, name, dev, dtype, (b, s, heads, e))
    _build.require(lse, "lse", dev, torch.float32, (b, heads, s))
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty((b, s, heads, e), device=dev, dtype=q.dtype)
                  for _ in range(3))
    lib = _build.load("flash", kdt_flash_bwd=_BWD_SIGNATURE,
                      kdt_flash_bwd_f32=_BWD_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            b, s, heads, e, q.stride(0), q.stride(1), scale,
            _build.stream_ptr(dev))
    global bwd_launches, bwd_launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_flash_bwd_f32", "flash backward", dev, *args)
        bwd_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_flash_bwd", "flash backward", dev, *args)
        bwd_launches += 1
    return dq, dk, dv


def flash_attention(q, k, v, scale=1.0):
    """Exact global attention: q, k, v (b, s, heads, e) -> (b, s, heads, e);
    differentiable. The kernels take bfloat16 or float32, e 32 or 64 and
    any s >= 1."""
    if q.device.type == "cpu":
        return residuals.plain(
            q, k, v, functools.partial(reference, scale=scale),
            functools.partial(reference_backward, scale=scale))
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_forward(q, k, v, scale)[0]  # no autograd node to build
    return residuals.attention(
        q, k, v, functools.partial(flash_forward, scale=scale, save_lse=True),
        functools.partial(flash_backward, scale=scale))
