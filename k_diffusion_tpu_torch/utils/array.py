"""Array helpers: dimension padding, the DCT and frequency weights
(counterpart of k_diffusion_tpu/utils/array.py).

torch has no DCT: ``dct`` and ``idct`` multiply by the orthonormal DCT-II
matrix of each axis, one cached float32 (n, n) matrix per length and
device, as ``augmentation.py`` builds its prefilter.
"""

import functools
import math

import torch


def append_dims(x, target_dims):
    """Appends singleton dims to the end of a tensor until it has
    ``target_dims`` dims."""
    dims_to_append = target_dims - x.ndim
    if dims_to_append < 0:
        raise ValueError(
            f"input has {x.ndim} dims but target_dims is {target_dims}, "
            "which is less")
    return x[(...,) + (None,) * dims_to_append]


@functools.lru_cache
def dct_matrix(n, device):
    """The orthonormal DCT-II matrix (n, n), float32: row k is frequency k,
    so y = M x along an axis and x = M^T y back."""
    i = torch.arange(n, dtype=torch.float64)
    m = torch.cos(math.pi * (2 * i[None, :] + 1) * i[:, None] / (2 * n))
    m[0] *= 1 / math.sqrt(2)
    return (m * math.sqrt(2 / n)).to(device, torch.float32)


def _along(x, axis, m):
    """m applied to the vectors along ``axis`` of x."""
    x = torch.movedim(x, axis, -1)
    return torch.movedim(x @ m.T.to(x.dtype), -1, axis)


def dct(x, axes):
    """Orthonormal DCT-II over the given axes."""
    for axis in axes:
        x = _along(x, axis, dct_matrix(x.shape[axis], x.device))
    return x


def idct(x, axes):
    """Orthonormal inverse DCT (DCT-III) over the given axes."""
    for axis in axes:
        x = _along(x, axis, dct_matrix(x.shape[axis], x.device).T)
    return x


def freq_weight_1d(n, scales=0, dtype=torch.float32, device=None):
    """Per-frequency loss weights for one axis: -log2 of a ramp from
    0.5 / n to 0.5, capped at ``scales`` where it is at least 1."""
    ramp = torch.linspace(0.5 / n, 0.5, n, dtype=dtype, device=device)
    weights = -torch.log2(ramp)
    if scales >= 1:
        weights = torch.clamp(weights, max=float(scales))
    return weights


def freq_weight_nd(shape, scales=0, dtype=torch.float32, device=None):
    """N-dimensional frequency weights: the elementwise minimum of the axes'
    1-D weights, each broadcast along the other axes."""
    out = None
    for i, n in enumerate(shape):
        w = freq_weight_1d(n, scales, dtype, device).reshape(
            [n if j == i else 1 for j in range(len(shape))])
        out = w if out is None else torch.minimum(out, w)
    return out


def transfer_params(new_state, old_state):
    """Carries ``old_state``'s tensors into ``new_state`` (two
    ``state_dict()``s) where a name is in both with the same shape, cast to
    the new tensor's dtype and device; the rest keep their fresh values.
    Progressive growing, as the JAX package does it: rebuild the model
    with new settings (``skip_stages``, ``patch_size``), then load what
    survived. Returns (state dict, n transferred, n total)."""
    out, n = dict(new_state), 0
    for name, t in new_state.items():
        old = old_state.get(name)
        if old is not None and old.shape == t.shape:
            out[name] = old.to(dtype=t.dtype, device=t.device)
            n += 1
    return out, n, len(new_state)
