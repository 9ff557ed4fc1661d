"""Convolutional EDM U-Net (counterpart of
k_diffusion_tpu/models/image_v1.py), eval and training forward.

Layouts follow the JAX package: activations are NHWC, and parameter names
mirror the flax tree (``u_net_d_1.res_0.conv_1.kernel``,
``u_net_d_1.res_0.norm_1.mapper.kernel``, ``u_net_d_1.attn_0.qkv_proj.bias``),
so a JAX checkpoint converts by renaming (``convert.py``). Convolution
kernels keep flax's HWIO layout (kh, kw, in, out) and Dense kernels (in,
out): the forward permutes a 3x3 kernel to PyTorch's (out, in, kh, kw),
laid out channels-last like the activations, and runs a 1x1 convolution as
a matmul on the NHWC tensor. An NHWC tensor permuted to NCHW is a
channels-last tensor, which cuDNN convolves without a copy. Parameters are
float32 and ``dtype`` is the compute dtype, cast at every product as the
flax layers do; GroupNorm statistics are float32.

Self-attention runs through ``ops.kernels.flash``: the hand-written
kernels K13 (forward) and K14 (backward) for CUDA tensors, their plain
version for CPU tensors. The down- and upsampling are the fixed low-pass
filters of ``layers``.

Cross-attention to a sequence (``cross_attn_depths``, ``cross_cond_dim``)
runs PyTorch ops: ``ops.attention.cross_attention``, one
``scaled_dot_product_attention`` with the JAX model's additive -1e4 bias
on padded keys (the JAX package runs it on XLA). With ``has_variance`` the
output head has one more channel, whose mean over the map is the
per-sample log variance (``return_variance=True``).

Under ``model.train()`` dropout applies where the JAX model applies it:
channel-wise (one mask value per image and channel) after each 3x3
convolution of a residual block, element-wise on the attention outputs.
The masks are drawn from the ``torch.Generator`` passed to ``forward``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (FourierFeatures, downsample2d, dropout,
                      init_tensor, upsample2d)
from ..ops.attention import cross_attention
from ..ops.kernels.flash import flash_attention
from ..utils import compute_dtype, default_device

def _space_to_depth(x, p):
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // p, w // p, p * p * c)


def _depth_to_space(x, p):
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, p, p, c // (p * p)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, c // (p * p))


class _Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) and an optional ``bias``."""

    def __init__(self, features_in, features_out, init="lecun", bias=True,
                 generator=None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(init_tensor(
            (features_in, features_out), init, generator, device))
        self.bias = (nn.Parameter(torch.zeros(features_out, device=device))
                     if bias else None)

    def forward(self, x, dtype):
        y = x.to(dtype) @ self.kernel.to(dtype)
        return y if self.bias is None else y + self.bias.to(dtype)


class _Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME'-sized zero padding on NHWC input:
    ``kernel`` (kh, kw, in, out) and an optional ``bias``."""

    def __init__(self, c_in, c_out, size, init="lecun", bias=True,
                 generator=None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(init_tensor(
            (size, size, c_in, c_out), init, generator, device))
        self.bias = (nn.Parameter(torch.zeros(c_out, device=device))
                     if bias else None)

    def forward(self, x, dtype):
        bias = None if self.bias is None else self.bias.to(dtype)
        if self.kernel.shape[0] == 1:  # a 1x1 convolution is a matmul
            y = x.to(dtype) @ self.kernel[0, 0].to(dtype)
            return y if bias is None else y + bias
        weight = self.kernel.permute(3, 2, 0, 1).to(
            dtype=dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight, bias,
                     padding=self.kernel.shape[0] // 2)
        return y.permute(0, 2, 3, 1)


def group_norm(x, num_groups, eps=1e-5):
    """flax ``nn.GroupNorm`` without scale or bias on NHWC ``x``: statistics
    over (h, w, c / groups) in float32 with the fast variance E[x^2] -
    E[x]^2 (clipped at 0), as flax computes them; the result in x's
    dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0)
    return ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(x.dtype)


class AdaGN(nn.Module):
    """Adaptive GroupNorm: GroupNorm without affine, eps 1e-5, then FiLM
    x * (weight + 1) + bias from a zero-init Dense ``mapper`` of cond."""

    def __init__(self, c, cond_dim, num_groups, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.mapper = _Dense(cond_dim, 2 * c, "zeros", device=device)

    def forward(self, x, cond, dtype):
        weight, bias = self.mapper(cond, dtype).chunk(2, dim=-1)
        x = group_norm(x, self.num_groups)
        return x * (weight[:, None, None, :] + 1) + bias[:, None, None, :]


class ResConvBlock(nn.Module):
    """AdaGN -> GELU -> 3x3 conv -> channel dropout, twice; the second conv
    zero-init; a bias-free orthogonal 1x1 skip where the channels change."""

    def __init__(self, c_in, c_mid, c_out, cond_dim, dropout_rate=0.0,
                 group_size=32, generator=None, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm_1 = AdaGN(c_in, cond_dim, max(1, c_in // group_size), device)
        self.conv_1 = _Conv(c_in, c_mid, 3, generator=generator, device=device)
        self.norm_2 = AdaGN(c_mid, cond_dim, max(1, c_mid // group_size),
                            device)
        self.conv_2 = _Conv(c_mid, c_out, 3, "zeros", device=device)
        self.skip = (_Conv(c_in, c_out, 1, "orthogonal", bias=False,
                           generator=generator, device=device)
                     if c_in != c_out else None)

    def _drop(self, h, generator):
        if not (self.training and self.dropout_rate):
            return h
        return dropout(h, self.dropout_rate, generator,
                       (h.shape[0], 1, 1, h.shape[3]))

    def forward(self, x, cond, dtype, generator=None):
        h = F.gelu(self.norm_1(x, cond, dtype))
        h = self._drop(self.conv_1(h, dtype), generator)
        h = F.gelu(self.norm_2(h, cond, dtype))
        h = self._drop(self.conv_2(h, dtype), generator)
        skip = x if self.skip is None else self.skip(x, dtype)
        return h + skip


class SelfAttention2d(nn.Module):
    """AdaGN -> 1x1 qkv conv -> global attention over the h * w positions
    (kernel K13, scale e^-1/2) -> dropout -> zero-init 1x1 out conv ->
    residual."""

    def __init__(self, c, n_head, cond_dim, dropout_rate=0.0, group_size=32,
                 generator=None, device=None):
        super().__init__()
        self.n_head, self.dropout_rate = n_head, dropout_rate
        self.norm_in = AdaGN(c, cond_dim, max(1, c // group_size), device)
        self.qkv_proj = _Conv(c, 3 * c, 1, generator=generator, device=device)
        self.out_proj = _Conv(c, c, 1, "zeros", device=device)

    def forward(self, x, cond, dtype, generator=None):
        b, h, w, c = x.shape
        qkv = self.qkv_proj(self.norm_in(x, cond, dtype), dtype)
        # strided views of the projection: the kernels take them as they are
        q, k, v = qkv.reshape(b, h * w, 3, self.n_head,
                              c // self.n_head).unbind(2)
        att = flash_attention(q, k, v, scale=(c // self.n_head) ** -0.5)
        att = att.reshape(b, h, w, c)
        if self.training and self.dropout_rate:
            att = dropout(att, self.dropout_rate, generator)
        return x + self.out_proj(att, dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics over the last axis in float32 with
    the fast variance E[x^2] - E[x]^2 (clipped at 0), epsilon 1e-6 (not
    PyTorch's 1e-5), then a learned ``scale`` and ``bias``; the result in
    float32, the promotion of x and the float32 params."""

    def __init__(self, features, eps=1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class CrossAttention2d(nn.Module):
    """Image-to-sequence attention: AdaGN -> 1x1 q conv; LayerNorm of the
    sequence -> kv Dense; attention with the keys' padding as an additive
    -1e4 bias (scale e^-1/2) -> dropout -> zero-init 1x1 out conv ->
    residual."""

    def __init__(self, c, c_enc, n_head, cond_dim, dropout_rate=0.0,
                 group_size=32, generator=None, device=None):
        super().__init__()
        self.n_head, self.dropout_rate = n_head, dropout_rate
        self.norm_dec = AdaGN(c, cond_dim, max(1, c // group_size), device)
        self.q_proj = _Conv(c, c, 1, generator=generator, device=device)
        self.norm_enc = LayerNorm(c_enc, device=device)
        self.kv_proj = _Dense(c_enc, 2 * c, generator=generator,
                              device=device)
        self.out_proj = _Conv(c, c, 1, "zeros", device=device)

    def forward(self, x, cond, cross, cross_padding, dtype, generator=None):
        b, h, w, c = x.shape
        e = c // self.n_head
        q = self.q_proj(self.norm_dec(x, cond, dtype), dtype).reshape(
            b, h * w, self.n_head, e)
        kv = self.kv_proj(self.norm_enc(cross), dtype).reshape(
            b, -1, 2, self.n_head, e)
        k, v = kv.unbind(2)
        att = cross_attention(q, k, v, cross_padding, scale=e ** -0.5)
        att = att.reshape(b, h, w, c)
        if self.training and self.dropout_rate:
            att = dropout(att, self.dropout_rate, generator)
        return x + self.out_proj(att, dtype)


class MappingNet(nn.Module):
    """n x (orthogonal-init Dense -> GELU)."""

    def __init__(self, feats_in, feats_out, n_layers=2, generator=None,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"linear_{i}", _Dense(
                feats_in if i == 0 else feats_out, feats_out, "orthogonal",
                generator=generator, device=device))

    def forward(self, x, dtype):
        for i in range(self.n_layers):
            x = F.gelu(getattr(self, f"linear_{i}")(x, dtype))
        return x


class _Stack(nn.Module):
    """One down or up stack: residual blocks ``res_{i}``, each followed by
    self-attention ``attn_{i}`` and cross-attention ``cross_{i}`` when the
    level has them. The last block narrows to ``c_out``; attention heads
    are 64 wide."""

    def __init__(self, n_layers, c_in, c_mid, c_out, cond_dim, self_attn,
                 dropout_rate, head_size=64, cross_attn=False, c_enc=0,
                 generator=None, device=None):
        super().__init__()
        self.n_layers, self.self_attn = n_layers, self_attn
        self.cross_attn = cross_attn
        for i in range(n_layers):
            my_c_out = c_mid if i < n_layers - 1 else c_out
            self.add_module(f"res_{i}", ResConvBlock(
                c_in if i == 0 else c_mid, c_mid, my_c_out, cond_dim,
                dropout_rate, generator=generator, device=device))
            if self_attn:
                self.add_module(f"attn_{i}", SelfAttention2d(
                    my_c_out, max(1, my_c_out // head_size), cond_dim,
                    dropout_rate, generator=generator, device=device))
            if cross_attn:
                self.add_module(f"cross_{i}", CrossAttention2d(
                    my_c_out, c_enc, max(1, my_c_out // head_size), cond_dim,
                    dropout_rate, generator=generator, device=device))

    def forward(self, x, cond, dtype, generator=None, cross=None,
                cross_padding=None):
        for i in range(self.n_layers):
            x = getattr(self, f"res_{i}")(x, cond, dtype, generator)
            if self.self_attn:
                x = getattr(self, f"attn_{i}")(x, cond, dtype, generator)
            if self.cross_attn:
                x = getattr(self, f"cross_{i}")(x, cond, cross, cross_padding,
                                                dtype, generator)
        return x


class ImageDenoiserModelV1(nn.Module):
    """EDM U-Net denoiser.

    ``model(x, sigma, mapping_cond=None, unet_cond=None, cross_cond=None,
    cross_cond_padding=None, return_variance=False, generator=None)`` with
    x (b, h, w, c) NHWC and sigma (b,); returns float32 (b, h, w, c), and
    with ``return_variance`` on a model with ``has_variance`` also the
    float32 (b,) log variance. ``mapping_cond`` (b, mapping_cond_dim) joins
    the timestep embedding through a bias-free Dense; ``unet_cond`` (b, h,
    w, unet_cond_dim) is concatenated to x's channels; ``cross_cond`` (b,
    s, cross_cond_dim) is the sequence the ``cross_attn_depths`` levels
    attend to, ``cross_cond_padding`` (b, s) set where it is padding. ``generator`` draws the dropout masks
    under ``model.train()``. Parameters are drawn from the constructor's
    ``generator`` on ``device`` (default: the card); the FourierFeatures
    basis too (``convert.py`` carries a JAX basis across). ``dtype`` is the
    compute dtype (default: bfloat16 on the card, float32 elsewhere;
    ``utils.compute_dtype``); on the card bfloat16 or float32 (its kernels
    are the flash pair K13/K14, which have float32 forms)."""

    def __init__(self, c_in, feats_in, depths, channels, self_attn_depths,
                 cross_attn_depths=None, mapping_cond_dim=0, unet_cond_dim=0,
                 cross_cond_dim=0, dropout_rate=0.0, patch_size=1,
                 skip_stages=0, has_variance=False, dtype=None,
                 device=None, generator=None):
        super().__init__()
        device = default_device(device)
        dtype = compute_dtype(device, dtype)
        n = len(depths)
        self.depths, self.skip_stages = depths, skip_stages
        self.patch_size, self.dtype = patch_size, dtype
        self.mapping_cond_dim = mapping_cond_dim
        self.has_variance = has_variance
        if not cross_cond_dim or cross_attn_depths is None:
            cross_attn_depths = (False,) * len(self_attn_depths)
        self.timestep_embed = FourierFeatures(1, feats_in, generator=generator,
                                              device=device)
        if mapping_cond_dim:
            self.mapping_cond = _Dense(mapping_cond_dim, feats_in, bias=False,
                                       generator=generator, device=device)
        self.mapping = MappingNet(feats_in, feats_in, generator=generator,
                                  device=device)
        width = channels[max(0, skip_stages - 1)]
        self.proj_in = _Conv((c_in + unet_cond_dim) * patch_size ** 2, width,
                             1, generator=generator, device=device)
        for i in range(skip_stages, n):
            self.add_module(f"u_net_d_{i}", _Stack(
                depths[i], width, channels[i], channels[i], feats_in,
                self_attn_depths[i], dropout_rate,
                cross_attn=cross_attn_depths[i], c_enc=cross_cond_dim,
                generator=generator, device=device))
            width = channels[i]
        for idx, i in enumerate(reversed(range(skip_stages, n))):
            c_up = width + (channels[i] if idx > 0 else 0)
            self.add_module(f"u_net_u_{i}", _Stack(
                depths[i], c_up, channels[i], channels[max(0, i - 1)],
                feats_in, self_attn_depths[i], dropout_rate,
                cross_attn=cross_attn_depths[i], c_enc=cross_cond_dim,
                generator=generator, device=device))
            width = channels[max(0, i - 1)]
        self.proj_out = _Conv(width, c_in * patch_size ** 2 + has_variance,
                              1, "zeros", device=device)

    def forward(self, x, sigma, mapping_cond=None, unet_cond=None,
                cross_cond=None, cross_cond_padding=None,
                return_variance=False, generator=None):
        dtype = self.dtype
        x = x.to(dtype)
        c_noise = torch.log(sigma.float()) / 4
        ts_embed = self.timestep_embed(c_noise[:, None]).to(dtype)
        if mapping_cond is not None:
            if not self.mapping_cond_dim:
                raise ValueError("mapping_cond given to a model built with "
                                 "mapping_cond_dim 0")
            ts_embed = ts_embed + self.mapping_cond(mapping_cond, dtype)
        cond = self.mapping(ts_embed, dtype)

        if unet_cond is not None:
            x = torch.cat([x, unet_cond.to(dtype)], dim=-1)
        if self.patch_size > 1:
            x = _space_to_depth(x, self.patch_size)
        x = self.proj_in(x, dtype)

        n = len(self.depths)
        skips = []
        for i in range(self.skip_stages, n):
            if i > self.skip_stages:
                x = downsample2d(x)
            x = getattr(self, f"u_net_d_{i}")(x, cond, dtype, generator,
                                              cross_cond, cross_cond_padding)
            skips.append(x)
        for idx, i in enumerate(reversed(range(self.skip_stages, n))):
            if idx > 0:
                x = torch.cat([x, skips[i - self.skip_stages]], dim=-1)
            x = getattr(self, f"u_net_u_{i}")(x, cond, dtype, generator,
                                              cross_cond, cross_cond_padding)
            if i > self.skip_stages:
                x = upsample2d(x)

        x = self.proj_out(x, dtype)
        if self.has_variance:
            x, logvar = x[..., :-1], x[..., -1].reshape(x.shape[0], -1).mean(1)
        if self.patch_size > 1:
            x = _depth_to_space(x, self.patch_size)
        if self.has_variance and return_variance:
            return x.float(), logvar.float()
        return x.float()


def param_group_labels(model):
    """{name: 'wd' or 'no_wd'} over ``model.named_parameters()``: weight
    decay only on the kernels of the mapping and U-Net modules, the JAX
    package's 2-group taxonomy."""
    labels = {}
    for name, _ in model.named_parameters():
        path = name.split(".")
        in_scope = path[0].startswith(("mapping", "u_net"))
        labels[name] = "wd" if in_scope and path[-1] == "kernel" else "no_wd"
    return labels
