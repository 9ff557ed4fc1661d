"""K5: the whole mapping network in one kernel (counterpart of
k_diffusion_tpu/ops/pallas/fused_mapping.py, forward only).

RMSNorm -> n x (RMSNorm -> GEGLU FF -> residual) -> RMSNorm on a (batch,
width) activation. CUDA tensors go to the hand-written kernel in
``csrc/geglu.cu``, which shares its GEGLU block code with K4; CPU tensors go
to ``reference``, the plain version.
"""

import ctypes

import torch

from ..geglu import linear_geglu
from ..norms import rms_norm
from . import _build

launches = 0  # kernel launches since the last reset

MAX_BATCH = 16  # one 16-row tensor-core strip

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


def fused_mapping(emb, in_scale, out_scale, blocks, eps=1e-6,
                  dtype=torch.bfloat16):
    """Returns the mapping-network output (b, d) in emb's dtype. The kernel
    takes bfloat16 emb and compute dtype, b <= MAX_BATCH, d and d_ff
    multiples of 64; the kernel's residual stream stays float32, as the
    Pallas kernel's does."""
    if emb.device.type == "cpu":
        return reference(emb, in_scale, out_scale, blocks, eps, dtype)
    _build.require_cuda(emb, "fused_mapping")
    b, d = emb.shape
    d_ff = blocks[0][2].shape[0]
    if dtype != torch.bfloat16 or b > MAX_BATCH or d % 64 or d_ff % 64:
        raise ValueError(
            f"fused_mapping kernel takes bfloat16, batch <= {MAX_BATCH} and "
            f"d, d_ff multiples of 64; got {tuple(emb.shape)}, d_ff={d_ff}, "
            f"{dtype}")
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
