"""Global and 2-D neighborhood attention, the plain versions of the
attention kernels (counterpart of k_diffusion_tpu/ops/attention.py).

Layouts follow the JAX package: q/k/v are (batch, seq, heads, head_dim) for
global attention and (batch, h, w, heads, head_dim) for neighborhood
attention. The softmax runs in float32 whatever the input dtype.
"""

from functools import lru_cache

import numpy as np
import torch


def _attention(q, k, v, scale, mask=None):
    """q/k/v (b, s, heads, e) -> (b, s, heads, e); mask (s_q, s_k) bool."""
    logits = torch.einsum("bqhe,bkhe->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhe->bqhe", p, v)


def global_attention(q, k, v, scale=1.0):
    """Full softmax attention. q/k/v: (batch, seq, heads, head_dim)."""
    return _attention(q, k, v, scale)


def global_logsumexp(q, k, scale=1.0):
    """The natural logsumexp of each query's scaled logits in float32,
    (batch, heads, seq), from q/k (batch, seq, heads, head_dim): what the
    global attention kernels save for their backward."""
    logits = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(logits, -1)


@lru_cache
def neighborhood_mask_1d(n, kernel_size):
    """1-D NATTEN mask: query i attends to the ``kernel_size`` window whose
    start is clamped inside [0, n - kernel_size], so edge queries see a full
    window shifted inward. Returns an (n, n) numpy bool array, cached: do
    not write to it."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    start = np.clip(i - (kernel_size - 1) // 2, 0, max(n - kernel_size, 0))
    return (j >= start) & (j < start + kernel_size)


def neighborhood_mask_2d(h, w, kernel_size, device):
    """2-D NATTEN mask over the h * w row-major tokens: (hw, hw) bool, the
    product of the two axes' 1-D masks."""
    mask_h = torch.from_numpy(neighborhood_mask_1d(h, min(kernel_size, h)))
    mask_w = torch.from_numpy(neighborhood_mask_1d(w, min(kernel_size, w)))
    mask_h, mask_w = mask_h.to(device), mask_w.to(device)
    return (mask_h[:, None, :, None] & mask_w[None, :, None, :]).reshape(
        h * w, h * w)


def neighborhood_attention(q, k, v, kernel_size, scale=1.0):
    """2-D neighborhood attention as masked dense attention.
    q/k/v: (batch, h, w, heads, head_dim). Each query attends to its
    kernel_size x kernel_size window, clamped at the edges. O((hw)^2)
    memory: this is the specification, not a fast path."""
    b, h, w, heads, e = q.shape
    mask = neighborhood_mask_2d(h, w, kernel_size, q.device)
    out = _attention(q.reshape(b, h * w, heads, e), k.reshape(b, h * w, heads, e),
                     v.reshape(b, h * w, heads, e), scale, mask)
    return out.reshape(b, h, w, heads, e)
