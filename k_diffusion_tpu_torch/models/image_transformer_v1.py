"""Flat ViT denoiser, version 1 (counterpart of
k_diffusion_tpu/models/image_transformer_v1.py).

Layouts and names follow the JAX package: NHWC input, tokens (b, l, d),
Dense kernels (in, out) at ``<module>.kernel``, parameter names of the flax
tree (``block_0.self_attn.pos_emb.freqs_h``), so a JAX checkpoint converts
by renaming (``convert.py``). Parameters are float32; ``dtype`` is the
compute dtype, cast at every matmul as the flax layers do.

- QKNorm: q and k RMS-normalised per head to exp(0.5 s - 0.25 log d_head),
  s the learned per-head log-scale clamped at log 100 (a minimum, not an
  in-place clamp);
- learned axial RoPE (``freqs_h``, ``freqs_w``, parameters with gradients)
  on interleaved pairs of the whole head;
- attention through the flash kernel K13 (K14 in training) at scale
  d_head ** -0.5 on top of QKNorm; q, k and v reach it as the three
  strided views of one (b, l, 3, heads, e) tensor, the layout it reads;
- AdaRMSNorm on the mapping output before each block, GEGLU feed-forward
  as plain matmuls (the JAX package leaves them to XLA);
- the HDiT's mapping network (kernel K5) at the ViT's width and d_ff, and
  its 4-group param taxonomy (``param_group_labels``).

Head dim 64, as the JAX model hard-codes it. With ``checkpointing`` every
block runs under ``torch.utils.checkpoint`` in training, its recompute
replaying the dropout masks (``layers.remat``).
"""

import math

import torch
from torch import nn

from ..layers import FourierFeatures, dropout, remat
from ..ops import norms, rope
from ..ops.geglu import linear_geglu
from ..ops.kernels.flash import flash_attention
from ..utils import compute_dtype, default_device
from .image_transformer_v2 import (MappingNetwork, RMSNorm, _AdaNorm,
                                   _Embedding, _Kernel, param_group_labels)

__all__ = ["ImageTransformerDenoiserModelV1", "param_group_labels"]

D_HEAD = 64


class AxialRoPEv1(nn.Module):
    """Learned-frequency axial RoPE: ``freqs_h``, ``freqs_w`` (heads, e / 4)
    log-frequencies, initialised log-spaced from pi to 5 pi."""

    def __init__(self, dim, n_heads, device=None):
        super().__init__()
        self.freqs_h = nn.Parameter(rope.freqs_pixel_log_init(
            (n_heads, dim // 4), 10.0, device))
        self.freqs_w = nn.Parameter(rope.freqs_pixel_log_init(
            (n_heads, dim // 4), 10.0, device))

    def forward(self, x, pos):
        """x (b, l, ..., heads, e); pos (l, 2)."""
        fh = pos[:, None, None, 0] * self.freqs_h.exp()  # (l, heads, e / 4)
        fw = pos[:, None, None, 1] * self.freqs_w.exp()
        freqs = torch.cat([fh, fw], dim=-1).repeat_interleave(2, dim=-1)
        l, heads, e = freqs.shape
        freqs = freqs.reshape(l, *[1] * (x.ndim - 4), heads, e)
        return rope.apply_rotary_emb_interleaved(freqs, x)


class SelfAttentionBlockV1(nn.Module):
    """AdaRMSNorm -> qkv -> QKNorm -> RoPE -> K13 -> dropout -> zero-init
    out projection -> residual."""

    def __init__(self, d_model, cond_features, dtype, generator, device,
                 dropout=0.0):
        super().__init__()
        self.d_model, self.dtype, self.dropout = d_model, dtype, dropout
        self.n_heads = d_model // D_HEAD
        self.norm = _AdaNorm(cond_features, d_model, device)
        self.qkv_proj = _Kernel((d_model, 3 * d_model), "lecun", generator,
                                device)
        self.qk_scale = nn.Parameter(torch.full((self.n_heads,),
                                                math.log(10.0), device=device))
        self.pos_emb = AxialRoPEv1(D_HEAD, self.n_heads, device)
        self.out_proj = _Kernel((d_model, d_model), "zeros", device=device)

    def forward(self, x, pos, cond, generator=None):
        b, l, d = x.shape
        dtype = self.dtype
        skip = x
        x = norms.rms_norm(x, self.norm(cond, dtype)[:, None, :])
        qkv = (x @ self.qkv_proj.kernel.to(dtype)).reshape(
            b, l, 3, self.n_heads, D_HEAD)
        s = torch.clamp(self.qk_scale, max=math.log(100.0))
        scale = torch.exp(0.5 * s - 0.25 * math.log(D_HEAD))[:, None]
        # QKNorm and RoPE on q and k together, then one (b, l, 3, heads,
        # e) tensor again, whose views K13 reads
        qk = self.pos_emb(norms.rms_norm(qkv[:, :, :2], scale), pos)
        q, k, v = torch.cat([qk, qkv[:, :, 2:]], dim=2).unbind(2)
        out = flash_attention(q, k, v, scale=D_HEAD ** -0.5).reshape(b, l, d)
        if self.training and self.dropout:
            out = dropout(out, self.dropout, generator)
        return out.to(dtype) @ self.out_proj.kernel.to(dtype) + skip


class FeedForwardBlockV1(nn.Module):
    """AdaRMSNorm -> GEGLU up -> dropout -> zero-init down -> residual, as
    plain matmuls."""

    def __init__(self, d_model, d_ff, cond_features, dtype, generator,
                 device, dropout=0.0):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.norm = _AdaNorm(cond_features, d_model, device)
        self.up_proj = _Kernel((d_model, 2 * d_ff), "lecun", generator, device)
        self.down_proj = _Kernel((d_ff, d_model), "zeros", device=device)

    def forward(self, x, cond, generator=None):
        dtype = self.dtype
        xn = norms.rms_norm(x, self.norm(cond, dtype)[:, None, :])
        hidden = linear_geglu(xn.to(dtype), self.up_proj.kernel.to(dtype))
        if self.training and self.dropout:
            hidden = dropout(hidden, self.dropout, generator)
        return hidden @ self.down_proj.kernel.to(dtype) + x


class TransformerBlockV1(nn.Module):
    def __init__(self, d_model, d_ff, cond_features, dtype, generator, device,
                 dropout=0.0):
        super().__init__()
        self.self_attn = SelfAttentionBlockV1(d_model, cond_features, dtype,
                                              generator, device, dropout)
        self.ff = FeedForwardBlockV1(d_model, d_ff, cond_features, dtype,
                                     generator, device, dropout)

    def forward(self, x, pos, cond, generator=None):
        x = self.self_attn(x, pos, cond, generator)
        return self.ff(x, cond, generator)


class ImageTransformerDenoiserModelV1(nn.Module):
    """Flat ViT denoiser.

    ``model(x, sigma, aug_cond=None, class_cond=None, generator=None)``
    with x (b, h, w, c) NHWC and sigma (b,); returns float32 (b, h, w, c).
    Tokens are ph x pw patches, features in (c, ph, pw) order. Parameters
    are drawn from ``generator`` on ``device`` (default: the card), the
    FourierFeatures bases too (``convert.py`` carries a JAX basis across);
    ``dtype`` is the compute dtype (default: bfloat16 on the card, float32
    elsewhere; ``utils.compute_dtype``; on the card bfloat16 or float32:
    its kernels, the flash pair K13/K14 and the mapping network K5, have
    both forms)."""

    def __init__(self, n_layers, d_model, d_ff, in_features, out_features,
                 patch_size, num_classes=0, dropout=0.0, checkpointing=False,
                 dtype=None, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        dtype = compute_dtype(device, dtype)
        self.n_layers, self.dtype = n_layers, dtype
        self.patch_size, self.num_classes = tuple(patch_size), num_classes
        self.checkpointing = checkpointing
        ph, pw = self.patch_size
        self.in_proj = _Kernel((in_features * ph * pw, d_model), "lecun",
                               generator, device)
        self.time_emb = FourierFeatures(1, d_model, generator=generator,
                                        device=device)
        self.time_in_proj = _Kernel((d_model, d_model), "lecun", generator,
                                    device)
        self.aug_emb = FourierFeatures(9, d_model, generator=generator,
                                       device=device)
        self.aug_in_proj = _Kernel((d_model, d_model), "lecun", generator,
                                   device)
        if num_classes:
            self.class_emb = _Embedding(num_classes, d_model, generator,
                                        device)
        self.mapping = MappingNetwork(2, d_model, d_ff, dtype, generator,
                                      device, dropout)
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlockV1(
                d_model, d_ff, d_model, dtype, generator, device, dropout))
        self.out_norm = RMSNorm(d_model, device=device)
        self.out_proj = _Kernel((d_model, out_features * ph * pw), "zeros",
                                device=device)

    def forward(self, x, sigma, aug_cond=None, class_cond=None,
                generator=None):
        if self.num_classes and class_cond is None:
            raise ValueError("class_cond must be specified if num_classes > 0")
        dtype = self.dtype
        b, h, w, c = x.shape
        ph, pw = self.patch_size
        h_out, w_out = h // ph, w // pw
        x = x.to(dtype).reshape(b, h_out, ph, w_out, pw, c).permute(
            0, 1, 3, 5, 2, 4).reshape(b, h_out * w_out, c * ph * pw)
        pos = rope.make_axial_pos(h_out, w_out, ph / pw,
                                  device=x.device).reshape(h_out * w_out, 2)
        x = x @ self.in_proj.kernel.to(dtype)

        c_noise = torch.log(sigma.float()) / 4
        emb = (self.time_emb(c_noise[..., None]).to(dtype)
               @ self.time_in_proj.kernel.to(dtype))
        if aug_cond is None:
            aug_cond = torch.zeros((b, 9), dtype=dtype, device=x.device)
        emb = emb + (self.aug_emb(aug_cond.to(dtype)).to(dtype)
                     @ self.aug_in_proj.kernel.to(dtype))
        if self.num_classes:
            emb = emb + self.class_emb.embedding.to(dtype)[class_cond]
        cond = self.mapping(emb, generator)

        checkpointed = self.checkpointing and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"block_{i}")
            if checkpointed:
                x = remat(block, generator, x, pos, cond)
            else:
                x = block(x, pos, cond, generator)

        x = self.out_norm(x).to(dtype) @ self.out_proj.kernel.to(dtype)
        x = x.reshape(b, h_out, w_out, -1, ph, pw).permute(
            0, 1, 4, 2, 5, 3).reshape(b, h, w, -1)
        return x.float()
