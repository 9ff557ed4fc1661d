"""Axial rotary position embeddings and position grids (counterpart of
k_diffusion_tpu/ops/rope.py)."""

import math

import torch


def apply_rotary_emb(x, theta, conj=False):
    """Rotates the first 2*theta.shape[-1] channels of x by theta
    (half-split convention: y1 = x1 cos - x2 sin, y2 = x2 cos + x1 sin);
    the remaining channels pass through."""
    out_dtype = x.dtype
    dtype = _promote(torch.promote_types(x.dtype, theta.dtype))
    d = theta.shape[-1]
    if d * 2 > x.shape[-1]:
        raise ValueError("theta is wider than half of x's last dim")
    x1, x2, x3 = x[..., :d], x[..., d:d * 2], x[..., d * 2:]
    x1, x2, theta = x1.to(dtype), x2.to(dtype), theta.to(dtype)
    cos, sin = torch.cos(theta), torch.sin(theta)
    sin = -sin if conj else sin
    y1 = (x1 * cos - x2 * sin).to(out_dtype)
    y2 = (x2 * cos + x1 * sin).to(out_dtype)
    return torch.cat([y1, y2, x3], dim=-1)


def _promote(dtype):
    return torch.promote_types(dtype, torch.float32)


def axial_rope_freqs(dim, n_heads, device=None):
    """Fixed log-spaced frequencies pi..10pi shared out across heads.
    Returns (n_heads, dim//4) float32."""
    log_min = math.log(math.pi)
    log_max = math.log(10.0 * math.pi)
    freqs = torch.exp(torch.linspace(log_min, log_max, n_heads * (dim // 4) + 1,
                                     dtype=torch.float32, device=device)[:-1])
    return freqs.reshape(dim // 4, n_heads).T


def axial_rope_theta(pos, freqs):
    """pos (..., 2) x freqs (n_heads, d//4) -> theta (..., n_heads, d//2):
    h-axis angles then w-axis angles."""
    theta_h = pos[..., None, 0:1] * freqs.to(pos.dtype)
    theta_w = pos[..., None, 1:2] * freqs.to(pos.dtype)
    return torch.cat([theta_h, theta_w], dim=-1)


def centers(start, stop, num, device=None):
    """Midpoints of num equal subintervals of [start, stop]."""
    edges = torch.linspace(start, stop, num + 1, dtype=torch.float32,
                           device=device)
    return (edges[:-1] + edges[1:]) / 2


def bounding_box(h, w, pixel_aspect_ratio=1.0):
    """Aspect-preserving [-1, 1] bounding box."""
    ar_adj = w / (h * pixel_aspect_ratio)
    y_min, y_max, x_min, x_max = -1.0, 1.0, -1.0, 1.0
    if ar_adj > 1:
        y_min, y_max = -1 / ar_adj, 1 / ar_adj
    elif ar_adj < 1:
        x_min, x_max = -ar_adj, ar_adj
    return y_min, y_max, x_min, x_max


def make_axial_pos(h, w, pixel_aspect_ratio=1.0, device=None):
    """(h, w, 2) float32 grid of normalized positions (cell centers)."""
    y_min, y_max, x_min, x_max = bounding_box(h, w, pixel_aspect_ratio)
    h_pos = centers(y_min, y_max, h, device=device)
    w_pos = centers(x_min, x_max, w, device=device)
    return torch.stack(torch.meshgrid(h_pos, w_pos, indexing="ij"), dim=-1)


def downscale_pos(pos):
    """Mean-pools a (h, w, 2) position grid 2x2."""
    h, w, e = pos.shape
    return pos.reshape(h // 2, 2, w // 2, 2, e).mean(dim=(1, 3))


def rotate_half_interleaved(x):
    """The ViT's rotate-half on interleaved pairs: (x0, x1, x2, x3, ...)
    -> (-x1, x0, -x3, x2, ...)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary_emb_interleaved(freqs, t, start_index=0, scale=1.0):
    """The ViT's RoPE, t cos + rotate_half(t) sin on interleaved pairs,
    over channels [start_index, start_index + freqs.shape[-1]) of t."""
    freqs = freqs.to(t.dtype)
    end_index = start_index + freqs.shape[-1]
    if end_index > t.shape[-1]:
        raise ValueError("freqs is wider than t")
    t_mid = t[..., start_index:end_index]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    t_mid = t_mid * cos + rotate_half_interleaved(t_mid) * sin
    if start_index == 0 and end_index == t.shape[-1]:
        return t_mid
    return torch.cat([t[..., :start_index], t_mid, t[..., end_index:]], dim=-1)


def freqs_pixel_log_init(shape, max_freq=10.0, device=None):
    """The ViT's learned RoPE log-frequencies at init: log(pi) to log(
    max_freq pi / 2), evenly spaced over the last dim of ``shape`` and
    broadcast over the rest. float32."""
    log_min = math.log(math.pi)
    log_max = math.log(max_freq * math.pi / 2)
    freqs = torch.linspace(log_min, log_max, shape[-1], dtype=torch.float32,
                           device=device)
    return freqs.expand(shape).clone()
