"""Shared building blocks (counterpart of k_diffusion_tpu/layers.py): flax's
initializers and dropout as the models use them, gradient checkpointing
that replays the dropout masks, the Fourier embedding, and the fixed
low-pass down- and upsampling of the U-Net."""

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .ops.kernels import residuals


def init_tensor(shape, init, generator=None, device=None):
    """flax's initializers for a kernel whose last dim is the output:
    "lecun" is lecun_normal (a normal truncated at two standard deviations,
    rescaled to variance 1 / fan_in, fan_in the product of the other dims),
    "orthogonal" an orthogonal (fan_in, out) matrix, "zeros" zeros."""
    t = torch.zeros(shape, device=device)
    fan_in = math.prod(shape[:-1])
    if init == "lecun":
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    elif init == "orthogonal":
        flat = torch.empty((fan_in, shape[-1]), device=device)
        t.copy_(nn.init.orthogonal_(flat, generator=generator).reshape(shape))
    return t


def dropout(x, rate, generator=None, shape=None):
    """flax's ``nn.Dropout``: keeps an element with probability 1 - rate
    and scales it by 1 / (1 - rate), the mask drawn from ``generator``. The
    mask has ``shape`` (default x's), broadcast over x: (b, 1, 1, c) is
    flax's ``broadcast_dims=(1, 2)``."""
    shape = x.shape if shape is None else shape
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep, x / (1 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# remat_policy names, as the JAX HDiT takes them: its named-residual
# policies (``save_*``) and ``jax.checkpoint_policies``' policy names, each
# as (attention residuals kept: None, "out" or "qkv"; matmul outputs saved:
# None, "all" or "no_batch"). "save_attn_qkv_raw" keeps what
# "save_attn_out" keeps: the JAX package names no tensor ``qkv_raw``.
REMAT_POLICIES = {
    "save_attn_out": ("out", None),
    "save_attn": ("qkv", None),
    "save_attn_qkv_raw": ("out", None),
    "nothing_saveable": (None, None),
    "dots_saveable": (None, "all"),
    "checkpoint_dots": (None, "all"),
    "dots_with_no_batch_dims_saveable": (None, "no_batch"),
    "checkpoint_dots_with_no_batch_dims": (None, "no_batch"),
}
# "everything_saveable" keeps every tensor: the layer runs without remat
NO_REMAT = "everything_saveable"
# jax.checkpoint_policies' factories: a name of one is not a policy
_POLICY_FACTORIES = {"save_only_these_names", "save_any_names_but_these",
                     "save_anything_except_these_names",
                     "save_from_both_policies", "offload_dot_with_no_batch_dims",
                     "save_and_offload_only_these_names"}


def check_remat_policy(name):
    """Raises ValueError unless ``name`` is None, ``NO_REMAT`` or a key of
    ``REMAT_POLICIES``."""
    if name is None or name == NO_REMAT or name in REMAT_POLICIES:
        return
    kind = ("a policy factory in jax.checkpoint_policies, not a policy"
            if name in _POLICY_FACTORIES else "not a remat policy")
    raise ValueError(f"remat_policy {name!r} is {kind}; the HDiT takes "
                     f"{sorted([*REMAT_POLICIES, NO_REMAT])}")


_DOTS = {"all": ("mm", "addmm", "bmm", "baddbmm"), "no_batch": ("mm", "addmm")}


def _dots_context(which):
    """A selective checkpoint that saves the outputs of aten's matmuls
    (``which``: "all", or "no_batch" for the unbatched ones) and recomputes
    the rest, as ``jax.checkpoint_policies.dots_saveable`` and
    ``dots_with_no_batch_dims_saveable`` do. The kernels, bound outside the
    dispatcher, are recomputed."""
    saved = {getattr(torch.ops.aten, name).default for name in _DOTS[which]}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


def remat(fn, generator, *args, policy=None):
    """``fn(*args, generator)`` under ``torch.utils.checkpoint``, which
    recomputes it in the backward. The checkpoint does not replay an
    explicit generator, so the recompute would draw new dropout masks: the
    generator's state at entry is kept, and the recompute runs from it and
    then puts back the state it found, so that the masks, and every later
    draw, are those of a run without checkpointing (as JAX's ``nn.remat``
    replays the same key).

    ``policy``, a key of ``REMAT_POLICIES`` (default: recompute all): a
    ``save_*`` policy keeps the attention kernels' outputs and logsumexp
    (and q, k, v under "save_attn") in a ``residuals.Stash``, so that the
    recompute launches no attention forward; a dots policy saves matmul
    outputs through torch's selective checkpointing."""
    keep, dots = REMAT_POLICIES[policy] if policy else (None, None)
    stash = residuals.Stash(keep_qkv=keep == "qkv") if keep else None
    entry = None if generator is None else generator.get_state()
    calls = []

    def run(*args):
        recompute = bool(calls)
        calls.append(1)
        with (residuals.recording(stash, recompute) if stash
              else contextlib.nullcontext()):
            if recompute and generator is not None:
                now = generator.get_state()
                generator.set_state(entry)
                try:
                    return fn(*args, generator)
                finally:
                    generator.set_state(now)
            return fn(*args, generator)

    kw = {"context_fn": _dots_context(dots)} if dots else {}
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             **kw)


class FourierFeatures(nn.Module):
    """Random Fourier embedding with a fixed gaussian basis.

    ``basis`` is an (in, out//2) buffer, the layout of the JAX package's
    ``basis`` param. The JAX package draws it from a fixed threefry key,
    which torch cannot reproduce: here it is drawn from the caller's
    ``torch.Generator``, and ``convert.py`` carries a JAX basis across."""

    def __init__(self, in_features, out_features, std=1.0, generator=None,
                 device=None):
        super().__init__()
        if out_features % 2:
            raise ValueError("out_features must be even")
        basis = torch.randn(in_features, out_features // 2,
                            generator=generator, dtype=torch.float32,
                            device=device) * std
        self.register_buffer("basis", basis)

    def forward(self, x):
        f = 2 * math.pi * (x.float() @ self.basis.float())
        return torch.cat([f.cos(), f.sin()], dim=-1).to(x.dtype)


_RESAMPLE_KERNELS = {
    "linear": [1 / 8, 3 / 8, 3 / 8, 1 / 8],
    "cubic": [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
              0.43359375, 0.11328125, -0.03515625, -0.01171875],
    "lanczos3": [0.003689131001010537, 0.015056144446134567, -0.03399861603975296,
                 -0.066637322306633, 0.13550527393817902, 0.44638532400131226,
                 0.44638532400131226, 0.13550527393817902, -0.066637322306633,
                 -0.03399861603975296, 0.015056144446134567, 0.003689131001010537],
}
_RESAMPLE_KERNELS["bilinear"] = _RESAMPLE_KERNELS["linear"]
_RESAMPLE_KERNELS["bicubic"] = _RESAMPLE_KERNELS["cubic"]


@functools.lru_cache
def _resample_kernel(kernel, device, gain):
    # made once per device: a tensor built from a list is copied from the
    # host, and on the card that copy waits for the stream
    return torch.tensor(_RESAMPLE_KERNELS[kernel], dtype=torch.float32,
                        device=device) * gain


def _resample_taps(kernel, c, device, gain=1.0):
    """The 1-D kernel as depthwise conv weights for c channels: (c, 1, k, 1)
    along h and (c, 1, 1, k) along w, float32."""
    k1d = _resample_kernel(kernel, device, gain).expand(c, 1, -1)
    return k1d[..., None], k1d[:, :, None, :]


def downsample2d(x, kernel="linear"):
    """Fixed low-pass stride-2 downsampling of NHWC ``x``, as the JAX
    package: reflect padding by len(kernel) // 2 - 1 on h and w, then a
    depthwise (groups=c) stride-2 convolution along h and one along w, in
    float32; the result in x's dtype."""
    b, h, w, c = x.shape
    taps_h, taps_w = _resample_taps(kernel, c, x.device)
    pad = taps_h.shape[2] // 2 - 1
    # an NHWC tensor permuted to NCHW is the channels-last layout
    y = F.pad(x.permute(0, 3, 1, 2).float(), (pad, pad, pad, pad),
              mode="reflect")
    y = F.conv2d(y, taps_h, stride=(2, 1), groups=c)
    y = F.conv2d(y, taps_w, stride=(1, 2), groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample2d(x, kernel="linear"):
    """Fixed low-pass 2x upsampling of NHWC ``x``, as the JAX package:
    reflect padding by (len(kernel) // 2) // 2 on h and w, then a transposed
    depthwise stride-2 convolution along h and one along w with the kernel
    at gain 2 per axis, in float32; the result in x's dtype. The transposed
    convolution is the JAX package's zero insertion (lhs dilation 2) and
    VALID convolution; the kernels are symmetric, so its flip changes
    nothing."""
    b, h, w, c = x.shape
    taps_h, taps_w = _resample_taps(kernel, c, x.device, gain=2.0)
    k = taps_h.shape[2]
    pad = (k // 2 - 1 + 1) // 2
    y = F.pad(x.permute(0, 3, 1, 2).float(), (pad, pad, pad, pad),
              mode="reflect")
    y = F.conv_transpose2d(y, taps_h, stride=(2, 1), padding=(k - 1, 0),
                           groups=c)
    y = F.conv_transpose2d(y, taps_w, stride=(1, 2), padding=(0, k - 1),
                           groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype)
