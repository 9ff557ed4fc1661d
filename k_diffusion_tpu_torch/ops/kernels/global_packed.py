"""K3 and K9: exact global attention on channel-packed maps and its backward
(counterpart of k_diffusion_tpu/ops/pallas/global_packed.py).

CUDA tensors go to the hand-written kernels in ``csrc/global_packed.cu``
through an autograd Function: the forward K3 (which also writes the per-head
logsumexp when a backward follows) and the backward K9, the wgmma kernels of
``csrc/attn_fwd.cuh`` and ``csrc/attn_bwd.cuh`` that K13 and K14 share (a
packed map is their strided layout at head dim 64); the Function saves
q, k, v, the output and the logsumexp, and under a remat policy keeps them
(``residuals``). CPU tensors go to
``reference``, the plain version, which autograd differentiates;
``reference_lse`` is the plain version of K3's logsumexp.

bfloat16 operands go to those wgmma kernels, float32 operands (a model
built with ``dtype=torch.float32``, ``--mixed-precision no``) to the
float32 forms that K13 and K14 share in ``csrc/attn_tf32.cuh``
(``kdt_global_packed_f32``, ``kdt_global_packed_bwd_f32``): the same
contract, products on the TF32 tensor cores with f32 accumulation. Each
dtype's launches are counted apart.
"""

import ctypes
import functools

import torch

from ..attention import global_attention, global_logsumexp
from . import _build, residuals

launches = 0      # K3 launches since the last reset, bfloat16
bwd_launches = 0  # K9 launches (its two kernels count as one), bfloat16
launches_f32 = 0      # K3 launches on float32 operands
bwd_launches_f32 = 0  # K9 launches on float32 operands

DTYPES = (torch.bfloat16, torch.float32)  # operand dtypes the kernels take

# the longest global level routed here: the JAX model's bound for its packed
# Pallas kernel (the CUDA kernels themselves take any s >= 1)
MAX_SEQ = 512

_P = ctypes.c_void_p
# q, k, v, out, lse, batch, seq, heads, scale, stream
_SIGNATURE = [_P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, _P]
# q, k, v, out, dout, lse, delta, dq, dk, dv, batch, seq, heads, scale,
# stream
_BWD_SIGNATURE = [_P] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, _P]


def reference(q, k, v, n_heads, scale=1.0):
    """Plain version: softmax attention per head, q/k/v (b, s, heads * e)."""
    b, s, c = q.shape
    split = (b, s, n_heads, c // n_heads)
    out = global_attention(q.reshape(split), k.reshape(split),
                           v.reshape(split), scale)
    return out.reshape(b, s, c)


def reference_lse(q, k, v, n_heads, scale=1.0):
    """Plain version of K3's logsumexp: (b, heads, s) float32, natural log,
    from q/k/v (b, s, heads * e); v is not read."""
    b, s, c = q.shape
    split = (b, s, n_heads, c // n_heads)
    return global_logsumexp(q.reshape(split), k.reshape(split), scale)


def reference_backward(q, k, v, dout, n_heads, scale=1.0):
    """Plain version of the backward: autograd through ``reference``.
    Returns (dq, dk, dv)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = reference(*inputs, n_heads, scale)
        return torch.autograd.grad(out, inputs, dout)


def takes(s, c, n_heads):
    """Whether K3 and K9 take a global level of s tokens and c = heads * e
    channels: e == 64 and s a multiple of 16 in [16, MAX_SEQ]. A routing
    decision, not a limit of the kernels (K3 and K13 run one kernel): the
    HDiT sends a global level that passes to K3 and any other to the flash
    kernel K13 (``flash.py``), as the JAX model routes between its two
    Pallas kernels (``packed_global_ok``)."""
    return c == 64 * n_heads and s % 16 == 0 and 16 <= s <= MAX_SEQ


def _check(q, n_heads, what):
    """Raises unless q is a CUDA tensor of a shape and dtype the kernels
    take. Returns its dtype, which every operand must share."""
    _build.require_cuda(q, what)
    b, s, c = q.shape
    if not takes(s, c, n_heads):
        raise ValueError(
            f"global_packed kernel takes head dim 64 and s a multiple of 16 "
            f"up to {MAX_SEQ}; got {tuple(q.shape)} with {n_heads} heads")
    if q.dtype not in DTYPES:
        raise ValueError(f"{what}: q is {q.dtype}; the kernels take "
                         f"bfloat16 or float32")
    return q.dtype


def packed_forward(q, k, v, n_heads, scale=1.0, save_lse=False):
    """Launches K3 (its float32 form on float32 operands) on CUDA tensors.
    Returns (out, lse): out in q's dtype, lse (b, heads, s) float32, or
    None unless ``save_lse``."""
    dtype = _check(q, n_heads, "packed_global_attention")
    b, s, c = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.device, dtype, (b, s, c))
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_heads, s), device=q.device, dtype=torch.float32)
           if save_lse else None)
    lib = _build.load("global_packed", kdt_global_packed=_SIGNATURE,
                      kdt_global_packed_f32=_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out)),
            None if lse is None else _build.ptr(lse), b, s, n_heads, scale,
            _build.stream_ptr(q.device))
    global launches, launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_global_packed_f32", "global_packed", q.device,
                      *args)
        launches_f32 += 1
    else:
        _build.launch(lib, "kdt_global_packed", "global_packed", q.device,
                      *args)
        launches += 1
    return out, lse


def packed_backward(q, k, v, out, lse, dout, n_heads, scale=1.0):
    """Launches K9 (its float32 form on float32 operands) on CUDA tensors:
    returns (dq, dk, dv) in q's dtype."""
    dtype = _check(q, n_heads, "packed_global_attention backward")
    b, s, c = q.shape
    dev = q.device
    dout = dout.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        _build.require(t, name, dev, dtype, (b, s, c))
    _build.require(lse, "lse", dev, torch.float32, (b, n_heads, s))
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _build.load("global_packed", kdt_global_packed_bwd=_BWD_SIGNATURE,
                      kdt_global_packed_bwd_f32=_BWD_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            b, s, n_heads, scale, _build.stream_ptr(dev))
    global bwd_launches, bwd_launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_global_packed_bwd_f32",
                      "global_packed backward", dev, *args)
        bwd_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_global_packed_bwd", "global_packed backward",
                      dev, *args)
        bwd_launches += 1
    return dq, dk, dv


def packed_global_attention(q, k, v, n_heads, scale=1.0):
    """q, k, v (b, s, heads * e) -> (b, s, heads * e); differentiable. The
    kernels take bfloat16 or float32, e == 64 and s a multiple of 16 up to
    MAX_SEQ."""
    static = {"n_heads": n_heads, "scale": scale}
    if q.device.type == "cpu":
        return residuals.plain(q, k, v, functools.partial(reference, **static),
                               functools.partial(reference_backward, **static))
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return packed_forward(q, k, v, n_heads, scale)[0]
    return residuals.attention(
        q, k, v, functools.partial(packed_forward, **static, save_lse=True),
        functools.partial(packed_backward, **static))
