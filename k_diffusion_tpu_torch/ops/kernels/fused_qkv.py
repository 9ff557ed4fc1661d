"""K1: the fused attention prologue (counterpart of
k_diffusion_tpu/ops/pallas/fused_qkv.py, forward only).

AdaRMSNorm(x, norm_scale) -> x @ W_qkv -> per-head cosine-sim scaling of q
and k -> axial RoPE on q and k, returning channel-packed (b, h, w, d) q, k, v.
CUDA tensors go to the hand-written kernel in ``csrc/fused_qkv.cu``; CPU
tensors to ``reference``, the plain version.
"""

import ctypes

import torch

from .. import norms, rope
from . import _build

launches = 0  # kernel launches since the last reset

# x, norm_scale, w_qkv, attn_scale, cos, sin, q, k, v, rows, tokens, d,
# heads, eps, cos_eps, stream
_SIGNATURE = [ctypes.c_void_p] * 9 + [
    ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_void_p]


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


def rope_tables(pos, n_heads, d_head):
    """cos and sin of the RoPE angles, (h * w, heads * d_head // 4) float32,
    built from the positions the model passes (the plain version's theta)."""
    theta = rope.axial_rope_theta(
        pos.float(), rope.axial_rope_freqs(d_head // 2, n_heads,
                                           device=pos.device))
    theta = theta.reshape(pos.shape[0] * pos.shape[1], -1)
    return torch.cos(theta).contiguous(), torch.sin(theta).contiguous()


def fused_qkv_prologue(x, pos, norm_scale, w_qkv, attn_scale, n_heads,
                       eps=1e-6, cos_eps=1e-6):
    """Returns (q, k, v), each (b, h, w, d), with cosine-sim scaling and RoPE
    applied to q and k. The kernel takes bfloat16 x and norm_scale, head
    dim 64 and d % 64 == 0; ``w_qkv`` is cast to x's dtype, as the JAX
    dispatcher does."""
    if x.device.type == "cpu":
        return reference(x, pos, norm_scale, w_qkv, attn_scale, n_heads, eps,
                         cos_eps)
    _build.require_cuda(x, "fused_qkv_prologue")
    b, h, w, d = x.shape
    if n_heads * 64 != d:
        raise ValueError(f"fused_qkv kernel needs head dim 64, got d={d} "
                         f"with {n_heads} heads")
    dev, bf16 = x.device, torch.bfloat16
    w_qkv = w_qkv.to(bf16)
    attn_scale = attn_scale.float()
    cos_t, sin_t = rope_tables(pos, n_heads, 64)
    _build.require(x, "x", dev, bf16, (b, h, w, d))
    _build.require(norm_scale, "norm_scale", dev, bf16, (b, d))
    _build.require(w_qkv, "w_qkv", dev, bf16, (d, 3 * d))
    _build.require(attn_scale, "attn_scale", dev, torch.float32, (n_heads,))
    _build.require(cos_t, "cos table", dev, torch.float32, (h * w, n_heads * 16))
    q, k, v = (torch.empty_like(x) for _ in range(3))
    lib = _build.load("fused_qkv", kdt_fused_qkv=_SIGNATURE)
    status = lib.kdt_fused_qkv(
        *map(_build.ptr, (x, norm_scale, w_qkv, attn_scale, cos_t, sin_t,
                          q, k, v)),
        b * h * w, h * w, d, n_heads, eps, cos_eps, _build.stream_ptr(dev))
    _build.check_launch(lib, status, "fused_qkv")
    global launches
    launches += 1
    return q, k, v
