"""Global and 2-D neighborhood attention, the plain versions of the
attention kernels, and shifted-window and cross attention (counterpart of
k_diffusion_tpu/ops/attention.py).

Layouts follow the JAX package: q/k/v are (batch, seq, heads, head_dim) for
global and cross attention and (batch, h, w, heads, head_dim) for
neighborhood and shifted-window attention. The softmax runs in float32
whatever the input dtype.

Shifted-window and cross attention have no kernel in the JAX package (it
runs ``jax.nn.dot_product_attention`` on XLA); here they are PyTorch ops:
a roll, the window partition by reshape and permute, and one
``scaled_dot_product_attention`` call with a mask.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


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


def window_partition(x, window_size):
    """(b, h, w, ...) -> (b, h // ws, w // ws, ws * ws, ...) window
    sequences."""
    b, h, w = x.shape[:3]
    rest = x.shape[3:]
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, *rest).transpose(2, 3)
    return x.reshape(b, h // ws, w // ws, ws * ws, *rest)


def window_unpartition(x, window_size):
    """The inverse of ``window_partition``."""
    b, nh, nw = x.shape[:3]
    rest = x.shape[4:]
    ws = window_size
    x = x.reshape(b, nh, nw, ws, ws, *rest).transpose(2, 3)
    return x.reshape(b, nh * ws, nw * ws, *rest)


@lru_cache
def make_shifted_window_masks(n_h_w, n_w_w, w_h, w_w, shift):
    """Block masks for shifted-window attention: after the roll by
    ``shift``, the top row and left column of windows stitch together
    pixels from opposite image edges, which must not attend to each other.
    Returns an (n_h_w, n_w_w, w_h * w_w, w_h * w_w) numpy bool array, True
    where a query may attend a key; cached: do not write to it."""
    ph = np.arange(n_h_w)[:, None, None, None, None, None]
    pw = np.arange(n_w_w)[None, :, None, None, None, None]
    qh = np.arange(w_h)[None, None, :, None, None, None]
    qw = np.arange(w_w)[None, None, None, :, None, None]
    kh = np.arange(w_h)[None, None, None, None, :, None]
    kw = np.arange(w_w)[None, None, None, None, None, :]
    is_top, is_left = ph == 0, pw == 0
    q_above, k_above = qh < shift, kh < shift
    q_left, k_left = qw < shift, kw < shift
    m_corner = is_left & is_top & (q_left == k_left) & (q_above == k_above)
    m_left = is_left & ~is_top & (q_left == k_left)
    m_top = ~is_left & is_top & (q_above == k_above)
    m_rest = ~is_left & ~is_top
    m = np.broadcast_to(m_corner | m_left | m_top | m_rest,
                        (n_h_w, n_w_w, w_h, w_w, w_h, w_w))
    return np.ascontiguousarray(m.reshape(n_h_w, n_w_w, w_h * w_w, w_h * w_w))


@lru_cache
def _window_mask(n_h_w, n_w_w, ws, shift, heads, device):
    """The masks as (1, windows x heads, ws^2, ws^2) bool on ``device``,
    made once per device: a mask copied from the host waits for the
    stream."""
    mask = torch.tensor(make_shifted_window_masks(n_h_w, n_w_w, ws, ws, shift),
                        device=device).reshape(n_h_w * n_w_w, 1, ws * ws, ws * ws)
    return mask.expand(-1, heads, -1, -1).reshape(1, -1, ws * ws, ws * ws)


def shifted_window_attention(q, k, v, window_size, window_shift, scale=1.0):
    """Attention within ws x ws windows of the map rolled by
    ``window_shift`` (0: no roll, no mask), rolled back after. q/k/v:
    (batch, h, w, heads, head_dim), h and w multiples of ws. One
    ``scaled_dot_product_attention`` over (batch, windows x heads)
    sequences of ws^2 tokens, the mask (windows x heads, ws^2, ws^2)
    broadcast over the batch."""
    b, h, w, heads, e = q.shape
    ws = window_size
    if window_shift:
        q, k, v = (torch.roll(t, (window_shift, window_shift), dims=(1, 2))
                   for t in (q, k, v))
    nh, nw, n = h // ws, w // ws, ws * ws
    # (b, nh, nw, ws^2, heads, e) -> (b, nh nw heads, ws^2, e)
    q, k, v = (window_partition(t, ws).reshape(b, nh * nw, n, heads, e)
               .transpose(2, 3).reshape(b, nh * nw * heads, n, e)
               for t in (q, k, v))
    mask = (_window_mask(nh, nw, ws, window_shift, heads, q.device)
            if window_shift else None)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    out = window_unpartition(
        out.reshape(b, nh, nw, heads, n, e).transpose(3, 4), ws)
    if window_shift:
        out = torch.roll(out, (-window_shift, -window_shift), dims=(1, 2))
    return out


def cross_attention(q, k, v, padding, scale):
    """Attention of q (batch, s_q, heads, e) over k, v (batch, s_k, heads,
    e) with an additive bias of -1e4 on the keys where ``padding``
    (batch, s_k) is set, in q's dtype, as the JAX U-Net builds it: a row
    whose keys are all padding has one bias on every key and attends as if
    none were, where a boolean mask would give it nothing (NaN).
    One ``scaled_dot_product_attention`` call."""
    bias = (padding[:, None, None, :] * -10000.0).to(q.dtype)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=bias, scale=scale)
    return out.transpose(1, 2)
