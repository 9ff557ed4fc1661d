"""K5: the whole mapping network in one kernel (counterpart of
k_diffusion_tpu/ops/pallas/fused_mapping.py).

RMSNorm -> n x (RMSNorm -> GEGLU FF -> residual) -> RMSNorm on a (batch,
width) activation. CUDA tensors go to the hand-written kernel in
``csrc/geglu.cu``, one block per 16-row strip of the batch, which shares its
GEGLU block code with K4; its backward recomputes through the plain version
under autograd, as the JAX custom_vjp does (there is no Pallas backward).
CPU tensors go to ``reference``, the plain version.
"""

import ctypes

import torch

from ..geglu import linear_geglu
from ..norms import rms_norm
from . import _build

launches = 0  # kernel launches since the last reset

# emb, in_scale, out_scale, norm_scales, w_up, w_down, out, batch, d, d_ff,
# n_blocks, eps, stream
_SIGNATURE = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p]


def reference(emb, in_scale, out_scale, blocks, eps=1e-6,
              dtype=torch.bfloat16):
    """Plain version: the MappingNetwork chain. emb (b, d); scales (d,);
    blocks: list of (norm_scale (d,), w_up (d, 2 d_ff), w_down (d_ff, d));
    ``dtype`` is the matmul compute dtype."""
    x = rms_norm(emb, in_scale, eps)
    for ns, w_up, w_down in blocks:
        h = linear_geglu(rms_norm(x, ns, eps).to(dtype), w_up.to(dtype))
        x = x + h.to(dtype) @ w_down.to(dtype)
    return rms_norm(x, out_scale, eps)


def mapping_forward(emb, in_scale, out_scale, blocks, eps=1e-6,
                    dtype=torch.bfloat16):
    """Launches K5 on CUDA tensors. Any batch: one block per 16 rows."""
    _build.require_cuda(emb, "fused_mapping")
    b, d = emb.shape
    d_ff = blocks[0][2].shape[0]
    if dtype != torch.bfloat16 or d % 64 or d_ff % 64:
        raise ValueError(
            f"fused_mapping kernel takes bfloat16 and d, d_ff multiples of "
            f"64; got {tuple(emb.shape)}, d_ff={d_ff}, {dtype}")
    dev, n = emb.device, len(blocks)
    f32, bf16 = torch.float32, torch.bfloat16
    norm_scales = torch.stack([ns.float() for ns, _, _ in blocks])
    w_up = torch.stack([wu.to(bf16) for _, wu, _ in blocks])
    w_down = torch.stack([wd.to(bf16) for _, _, wd in blocks])
    in_scale, out_scale = in_scale.float(), out_scale.float()
    _build.require(emb, "emb", dev, bf16, (b, d))
    _build.require(in_scale, "in_scale", dev, f32, (d,))
    _build.require(out_scale, "out_scale", dev, f32, (d,))
    _build.require(norm_scales, "norm scales", dev, f32, (n, d))
    _build.require(w_up, "w_up", dev, bf16, (n, d, 2 * d_ff))
    _build.require(w_down, "w_down", dev, bf16, (n, d_ff, d))
    out = torch.empty_like(emb)
    lib = _build.load("geglu", kdt_mapping=_SIGNATURE)
    status = lib.kdt_mapping(
        *map(_build.ptr, (emb, in_scale, out_scale, norm_scales, w_up, w_down,
                          out)),
        b, d, d_ff, n, eps, _build.stream_ptr(dev))
    _build.check_launch(lib, status, "fused_mapping")
    global launches
    launches += 1
    return out


def _unflatten(flat):
    return flat[0], flat[1], flat[2], [tuple(flat[i:i + 3])
                                       for i in range(3, len(flat), 3)]


class _Mapping(torch.autograd.Function):
    """K5 forward; the backward differentiates the plain version,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, eps, dtype, *flat):
        ctx.save_for_backward(*flat)
        ctx.static = (eps, dtype)
        emb, in_scale, out_scale, blocks = _unflatten(flat)
        return mapping_forward(emb, in_scale, out_scale, blocks, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        eps, dtype = ctx.static
        with torch.enable_grad():
            flat = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            emb, in_scale, out_scale, blocks = _unflatten(flat)
            out = reference(emb, in_scale, out_scale, blocks, eps, dtype)
            grads = torch.autograd.grad(out, flat, g)
        return (None, None, *grads)


def fused_mapping(emb, in_scale, out_scale, blocks, eps=1e-6,
                  dtype=torch.bfloat16):
    """Returns the mapping-network output (b, d) in emb's dtype;
    differentiable. The kernel takes bfloat16 emb and compute dtype, d and
    d_ff multiples of 64, any batch; its residual stream stays float32, as
    the Pallas kernel's does."""
    if emb.device.type == "cpu":
        return reference(emb, in_scale, out_scale, blocks, eps, dtype)
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return mapping_forward(emb, in_scale, out_scale, blocks, eps, dtype)
    flat = [emb, in_scale, out_scale, *(t for blk in blocks for t in blk)]
    return _Mapping.apply(eps, dtype, *flat)
