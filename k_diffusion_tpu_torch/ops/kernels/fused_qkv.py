"""K1 and K6: the fused attention prologue and its backward (counterpart of
k_diffusion_tpu/ops/pallas/fused_qkv.py).

AdaRMSNorm(x, norm_scale) -> x @ W_qkv -> per-head cosine-sim scaling of q
and k -> axial RoPE on q and k, returning channel-packed (b, h, w, d) q, k, v.
CUDA tensors go to the hand-written kernels in ``csrc/fused_qkv.cu`` through
an autograd Function whose backward is the kernel K6; CPU tensors to
``reference``, the plain version, which autograd differentiates.
"""

import ctypes

import torch

from .. import norms, rope
from . import _build

launches = 0      # forward kernel launches since the last reset
bwd_launches = 0  # backward kernel launches since the last reset

HEAD_DIMS = (32, 64)  # head dims the kernels take

_P = ctypes.c_void_p
# x, norm_scale, w_qkv, attn_scale, cos, sin, q, k, v, rows, tokens, d,
# heads, eps, cos_eps, stream
_SIGNATURE = [_P] * 9 + [ctypes.c_long, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]
# x, norm_scale, w_qkv, attn_scale, cos, sin, gq, gk, gv, dx, dns, dw,
# das_sums, dqk, xn, r, dot_part, das_part, dns_part, dw_part, images,
# tokens, d, heads, groups, chunk_rows, eps, cos_eps, stream
_BWD_SIGNATURE = [_P] * 20 + [ctypes.c_int] * 6 + [
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


def _operands(x, pos, norm_scale, w_qkv, attn_scale, n_heads):
    """Checks and casts the operands both kernels share."""
    b, h, w, d = x.shape
    e = d // n_heads
    if e * n_heads != d or e not in HEAD_DIMS or d % 64:
        raise ValueError(f"fused_qkv kernel takes head dim 32 or 64 and d a "
                         f"multiple of 64; got d={d} with {n_heads} heads")
    dev, bf16 = x.device, torch.bfloat16
    w_qkv = w_qkv.to(bf16)
    attn_scale = attn_scale.float()
    cos_t, sin_t = rope_tables(pos, n_heads, e)
    _build.require(x, "x", dev, bf16, (b, h, w, d))
    _build.require(norm_scale, "norm_scale", dev, bf16, (b, d))
    _build.require(w_qkv, "w_qkv", dev, bf16, (d, 3 * d))
    _build.require(attn_scale, "attn_scale", dev, torch.float32, (n_heads,))
    _build.require(cos_t, "cos table", dev, torch.float32,
                   (h * w, n_heads * e // 4))
    return w_qkv, attn_scale, cos_t, sin_t


def prologue_forward(x, pos, norm_scale, w_qkv, attn_scale, n_heads,
                     eps=1e-6, cos_eps=1e-6):
    """Launches K1 on CUDA tensors: returns (q, k, v)."""
    _build.require_cuda(x, "fused_qkv_prologue")
    b, h, w, d = x.shape
    w_qkv, attn_scale, cos_t, sin_t = _operands(x, pos, norm_scale, w_qkv,
                                                attn_scale, n_heads)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    lib = _build.load("fused_qkv", kdt_fused_qkv=_SIGNATURE)
    status = lib.kdt_fused_qkv(
        *map(_build.ptr, (x, norm_scale, w_qkv, attn_scale, cos_t, sin_t,
                          q, k, v)),
        b * h * w, h * w, d, n_heads, eps, cos_eps, _build.stream_ptr(x.device))
    _build.check_launch(lib, status, "fused_qkv")
    global launches
    launches += 1
    return q, k, v


def prologue_backward(x, pos, norm_scale, w_qkv, attn_scale, n_heads, gq, gk,
                      gv, eps=1e-6, cos_eps=1e-6):
    """Launches K6 on CUDA tensors: returns (dx, d norm_scale, d w_qkv,
    d attn_scale), each in its input's dtype (dx and d norm_scale bf16,
    the parameter gradients float32)."""
    _build.require_cuda(x, "fused_qkv_prologue backward")
    b, h, w, d = x.shape
    w16, scale32, cos_t, sin_t = _operands(x, pos, norm_scale, w_qkv,
                                           attn_scale, n_heads)
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
    status = lib.kdt_fused_qkv_bwd(
        *map(_build.ptr, (x, norm_scale, w16, scale32, cos_t, sin_t, gq, gk,
                          gv, dx, dns, dw, das_sums, dqk, xn, r, dot_part,
                          das_part, dns_part, dw_part)),
        b, tokens, d, n_heads, groups, chunk_rows, eps, cos_eps,
        _build.stream_ptr(dev))
    _build.check_launch(lib, status, "fused_qkv backward")
    global bwd_launches
    bwd_launches += 1
    das = (das_sums[:n_heads] + das_sums[n_heads:]) / (2 * scale32)
    return (dx, dns.to(norm_scale.dtype), dw.to(w_qkv.dtype),
            das.to(attn_scale.dtype))


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
    applied to q and k; differentiable. The kernels take bfloat16 x and
    norm_scale, head dim 32 or 64 and d % 64 == 0; ``w_qkv`` is cast to x's
    dtype, as the JAX dispatcher does."""
    if x.device.type == "cpu":
        return reference(x, pos, norm_scale, w_qkv, attn_scale, n_heads, eps,
                         cos_eps)
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return prologue_forward(x, pos, norm_scale, w_qkv, attn_scale,
                                n_heads, eps, cos_eps)
    return _Prologue.apply(x, pos, norm_scale, w_qkv, attn_scale, n_heads,
                           eps, cos_eps)
