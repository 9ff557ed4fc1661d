"""Normalization primitives (counterpart of k_diffusion_tpu/ops/norms.py)."""

import torch


def _promote(dtype):
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x, scale, eps=1e-6):
    """x * scale / rms(x), the reduction in float32 whatever x's dtype. The
    combined factor is cast to x's dtype before the multiply, the rounding
    point of the JAX package and of every kernel that fuses this norm."""
    dtype = _promote(x.dtype)
    mean_sq = x.to(dtype).square().mean(dim=-1, keepdim=True)
    factor = scale.to(dtype) * torch.rsqrt(mean_sq + eps)
    return x * factor.to(x.dtype)


def scale_for_cosine_sim(q, k, scale, eps=1e-6):
    """Normalizes q and k to norm sqrt(scale) per head (cosine-similarity
    attention with a learned per-head scale). ``scale`` must broadcast
    against the per-head sums of squares."""
    dtype = _promote(q.dtype)
    sum_sq_q = q.to(dtype).square().sum(dim=-1, keepdim=True)
    sum_sq_k = k.to(dtype).square().sum(dim=-1, keepdim=True)
    sqrt_scale = torch.sqrt(scale.to(dtype))
    scale_q = sqrt_scale * torch.rsqrt(sum_sq_q + eps)
    scale_k = sqrt_scale * torch.rsqrt(sum_sq_k + eps)
    return q * scale_q.to(q.dtype), k * scale_k.to(k.dtype)
