"""Hourglass Diffusion Transformer (HDiT), eval and training forward
(counterpart of k_diffusion_tpu/models/image_transformer_v2.py).

Layouts follow the JAX package: NHWC activations; Dense kernels stored
(in, out) as ``<module>.kernel``; parameter names mirror the flax tree
(``down_0_layer_0.self_attn.qkv_proj.kernel``), so a JAX checkpoint converts
by renaming (``convert.py``). Parameters are float32 and ``dtype`` is the
compute dtype, cast at every matmul as the flax layers do.

The attention prologue, both attention kinds, the feed-forward block and the
mapping network run through the wrappers in ``ops.kernels``: hand-written
kernels for CUDA tensors, their plain versions for CPU tensors; their
backwards are hand-written kernels too. The patch, merge, split and output
projections are plain matmuls, as XLA ran them.

Under ``model.train()`` each level's dropout applies where the JAX model
applies it: to the attention output before ``out_proj``, and to the GEGLU
hidden activation of the feed-forward blocks and the mapping network. A
block whose dropout is active runs the unfused plain chain (the fused
kernels contain no dropout), exactly as the JAX model routes. With
``KDT_TRAIN_FUSION=0`` (``ops.kernels.train_fusion_enabled``) training also
runs the attention prologue unfused, written out here, and every
feed-forward block unfused, as the JAX model does. Dropout masks are drawn
from the ``torch.Generator`` passed to ``forward``.
"""

from dataclasses import dataclass

import torch
from torch import nn

from ..layers import FourierFeatures, dropout, init_tensor
from ..ops import norms, rope
from ..ops.geglu import linear_geglu
from ..ops.kernels import global_packed, train_fusion_enabled
from ..ops.kernels.flash import flash_attention
from ..ops.kernels.fused_ffn import fused_geglu_ffn
from ..ops.kernels.fused_mapping import fused_mapping
from ..ops.kernels.fused_qkv import fused_qkv_prologue
from ..ops.kernels.na2d import na2d, na2d_packed, packed_takes
from ..utils import compute_dtype, default_device


@dataclass(frozen=True)
class GlobalAttentionSpec:
    d_head: int


@dataclass(frozen=True)
class NeighborhoodAttentionSpec:
    d_head: int
    kernel_size: int


@dataclass(frozen=True)
class LevelSpec:
    depth: int
    width: int
    d_ff: int
    self_attn: object
    dropout: float = 0.0


@dataclass(frozen=True)
class MappingSpec:
    depth: int
    width: int
    d_ff: int
    dropout: float = 0.0


class _Kernel(nn.Module):
    """Owns one Dense kernel at ``<name>.kernel``."""

    def __init__(self, shape, init, generator=None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(init_tensor(shape, init, generator, device))


class _Embedding(nn.Module):
    """Owns a class embedding table at ``<name>.embedding`` (classes,
    features), drawn as flax's default embedding init (a normal of variance
    1 / features)."""

    def __init__(self, classes, features, generator=None, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(
            (classes, features), generator=generator, device=device)
            * features ** -0.5)


class _Scale(nn.Module):
    """Owns one norm scale at ``<name>.scale``."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))


class _AdaNorm(nn.Module):
    """Owns an AdaRMSNorm projection at ``<name>.mapping_linear.kernel``
    (zero-init, so scale = proj(cond) + 1 starts at 1)."""

    def __init__(self, cond_features, d_model, device=None):
        super().__init__()
        self.mapping_linear = _Kernel((cond_features, d_model), "zeros",
                                      device=device)

    def forward(self, cond, dtype):
        return cond.to(dtype) @ self.mapping_linear.kernel.to(dtype) + 1


class RMSNorm(_Scale):
    def __init__(self, dim, eps=1e-6, device=None):
        super().__init__(dim, device)
        self.eps = eps

    def forward(self, x):
        return norms.rms_norm(x, self.scale, self.eps)


class SelfAttentionBlock(nn.Module):
    """AdaRMSNorm -> qkv -> cosine-sim + RoPE (kernel K1) -> neighborhood
    or global attention -> dropout -> out projection -> residual.

    In training with ``KDT_TRAIN_FUSION=0`` the prologue runs unfused, as
    the JAX model's does. A neighborhood level goes to the channel-packed K2
    where ``na2d.packed_takes`` its width and head dim and the prologue ran
    fused, and to the per-head K11 otherwise (the unfused prologue, a level
    wider than 512 or not a multiple of 128, a head dim other than 64). A
    global level goes to K3 where ``global_packed.takes`` it (head dim 64,
    s a multiple of 16 up to 512) and to the flash kernel K13 otherwise."""

    def __init__(self, d_model, attn_spec, cond_features, dtype, generator,
                 device, dropout=0.0):
        super().__init__()
        self.d_model, self.attn_spec, self.dtype = d_model, attn_spec, dtype
        self.dropout = dropout
        self.n_heads = d_model // attn_spec.d_head
        self.qkv_proj = _Kernel((d_model, 3 * d_model), "lecun", generator,
                                device)
        self.out_proj = _Kernel((d_model, d_model), "zeros", device=device)
        self.scale = nn.Parameter(torch.full((self.n_heads,), 10.0,
                                             device=device))
        self.norm = _AdaNorm(cond_features, d_model, device)

    def _unfused_prologue(self, x, pos, norm_scale):
        """The JAX model's unfused chain: AdaRMSNorm -> qkv -> cosine-sim ->
        RoPE, returning (b, h, w, heads, e) q and k and v, a strided view of
        the projection."""
        b, h, w, _ = x.shape
        e = self.attn_spec.d_head
        xn = norms.rms_norm(x, norm_scale[:, None, None, :])
        qkv = (xn @ self.qkv_proj.kernel.to(xn.dtype)).reshape(
            b, h, w, 3, self.n_heads, e)
        q, k, v = qkv.unbind(3)
        q, k = norms.scale_for_cosine_sim(q, k, self.scale[:, None], 1e-6)
        theta = rope.axial_rope_theta(pos, rope.axial_rope_freqs(
            e // 2, self.n_heads, device=x.device))
        return rope.apply_rotary_emb(q, theta), rope.apply_rotary_emb(k, theta), v

    def forward(self, x, pos, cond, generator=None):
        b, h, w, c = x.shape
        e = self.attn_spec.d_head
        norm_scale = self.norm(cond, self.dtype)
        fused = not self.training or train_fusion_enabled()
        if fused:
            q, k, v = (t.reshape(b, h, w, self.n_heads, e)
                       for t in fused_qkv_prologue(
                           x, pos, norm_scale, self.qkv_proj.kernel,
                           self.scale, self.n_heads))
        else:
            q, k, v = self._unfused_prologue(x, pos, norm_scale)
        if isinstance(self.attn_spec, GlobalAttentionSpec):
            # the kernels read q, k, v of one layout: the unfused v is a
            # strided view of the projection
            q, k, v = (t.contiguous() for t in (q, k, v))
            if global_packed.takes(h * w, c, self.n_heads):
                out = global_packed.packed_global_attention(
                    q.reshape(b, h * w, c), k.reshape(b, h * w, c),
                    v.reshape(b, h * w, c), self.n_heads, scale=1.0)
            else:
                split = (b, h * w, self.n_heads, e)
                out = flash_attention(q.reshape(split), k.reshape(split),
                                      v.reshape(split), scale=1.0)
        elif fused and packed_takes(c, e):
            out = na2d_packed(*(t.reshape(b, h, w, c) for t in (q, k, v)),
                              self.n_heads, self.attn_spec.kernel_size,
                              scale=1.0)
        else:
            out = na2d(q, k, v, self.attn_spec.kernel_size, scale=1.0)
        out = out.reshape(b, h, w, c)
        if self.training and self.dropout:
            out = dropout(out, self.dropout, generator)
        return out.to(self.dtype) @ self.out_proj.kernel.to(self.dtype) + x


class FeedForwardBlock(nn.Module):
    """x + down(GEGLU(up(AdaRMSNorm(x, cond)))) as kernel K4; in training
    with dropout active or ``KDT_TRAIN_FUSION=0``, the unfused chain norm ->
    GEGLU up -> dropout -> down -> residual, as the JAX model routes."""

    def __init__(self, d_model, d_ff, cond_features, generator, device,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.up_proj = _Kernel((d_model, 2 * d_ff), "lecun", generator, device)
        self.down_proj = _Kernel((d_ff, d_model), "zeros", device=device)
        self.norm = _AdaNorm(cond_features, d_model, device)

    def forward(self, x, cond, generator=None):
        b, h, w, d = x.shape
        scale = self.norm(cond, cond.dtype)
        if not (self.training
                and (self.dropout or not train_fusion_enabled())):
            out = fused_geglu_ffn(x.reshape(b, h * w, d), scale,
                                  self.up_proj.kernel, self.down_proj.kernel)
            return out.reshape(b, h, w, d)
        xn = norms.rms_norm(x, scale[:, None, None, :].to(x.dtype))
        hidden = linear_geglu(xn, self.up_proj.kernel.to(x.dtype))
        hidden = dropout(hidden, self.dropout, generator)
        return hidden @ self.down_proj.kernel.to(x.dtype) + x


class TransformerLayer(nn.Module):
    def __init__(self, spec, cond_features, dtype, generator, device):
        super().__init__()
        self.self_attn = SelfAttentionBlock(spec.width, spec.self_attn,
                                            cond_features, dtype, generator,
                                            device, spec.dropout)
        self.ff = FeedForwardBlock(spec.width, spec.d_ff, cond_features,
                                   generator, device, spec.dropout)

    def forward(self, x, pos, cond, generator=None):
        return self.ff(self.self_attn(x, pos, cond, generator), cond, generator)


class _MappingBlock(nn.Module):
    def __init__(self, d_model, d_ff, generator, device):
        super().__init__()
        self.norm = _Scale(d_model, device)
        self.up_proj = _Kernel((d_model, 2 * d_ff), "lecun", generator, device)
        self.down_proj = _Kernel((d_ff, d_model), "zeros", device=device)


class MappingNetwork(nn.Module):
    """RMSNorm -> n x (RMSNorm -> GEGLU FF -> residual) -> RMSNorm as
    kernel K5; with dropout active, the unfused chain with dropout on each
    GEGLU hidden activation."""

    def __init__(self, n_layers, d_model, d_ff, dtype, generator, device,
                 dropout=0.0):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.in_norm = _Scale(d_model, device)
        for i in range(n_layers):
            self.add_module(f"block_{i}",
                            _MappingBlock(d_model, d_ff, generator, device))
        self.n_layers = n_layers
        self.out_norm = _Scale(d_model, device)

    def forward(self, x, generator=None):
        blocks = [(blk.norm.scale, blk.up_proj.kernel, blk.down_proj.kernel)
                  for blk in (getattr(self, f"block_{i}")
                              for i in range(self.n_layers))]
        if not (self.training and self.dropout):
            return fused_mapping(x, self.in_norm.scale, self.out_norm.scale,
                                 blocks, dtype=self.dtype)
        dtype = self.dtype
        x = norms.rms_norm(x, self.in_norm.scale)
        for ns, w_up, w_down in blocks:
            hidden = linear_geglu(norms.rms_norm(x, ns).to(dtype), w_up.to(dtype))
            hidden = dropout(hidden, self.dropout, generator)
            x = x + hidden.to(dtype) @ w_down.to(dtype)
        return norms.rms_norm(x, self.out_norm.scale)


def _patch(x, ph, pw):
    """(b, h, w, c) -> (b, h/ph, w/pw, ph*pw*c), features in (ph, pw, c)
    order, the row order of the JAX patch kernels."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // ph, w // pw, ph * pw * c)


def _unpatch(x, ph, pw):
    """Inverse of _patch."""
    b, h, w, f = x.shape
    c = f // (ph * pw)
    x = x.reshape(b, h, w, ph, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * ph, w * pw, c)


class TokenMerge(nn.Module):
    """ph x pw pixel-shuffle downsample as one linear."""

    def __init__(self, in_features, out_features, patch_size, dtype, generator,
                 device):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        ph, pw = patch_size
        self.proj = _Kernel((ph * pw * in_features, out_features), "lecun",
                            generator, device)

    def forward(self, x):
        x = _patch(x, *self.patch_size)
        return x.to(self.dtype) @ self.proj.kernel.to(self.dtype)


class TokenSplitWithoutSkip(nn.Module):
    """Linear + pixel-unshuffle upsample (the output head)."""

    def __init__(self, in_features, out_features, patch_size, dtype, generator,
                 device, zero_init=False):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        ph, pw = patch_size
        self.proj = _Kernel((in_features, ph * pw * out_features),
                            "zeros" if zero_init else "lecun", generator,
                            device)

    def forward(self, x):
        x = x.to(self.dtype) @ self.proj.kernel.to(self.dtype)
        return _unpatch(x, *self.patch_size)


class TokenSplit(TokenSplitWithoutSkip):
    """Upsample + learned lerp skip merge, fac init 0.5."""

    def __init__(self, in_features, out_features, dtype, generator, device):
        super().__init__(in_features, out_features, (2, 2), dtype, generator,
                         device)
        self.fac = nn.Parameter(torch.full((1,), 0.5, device=device))

    def forward(self, x, skip):
        x = super().forward(x)
        return skip + (x - skip) * self.fac.to(x.dtype)


class ImageTransformerDenoiserModelV2(nn.Module):
    """Multi-level hourglass transformer denoiser.

    ``model(x, sigma, aug_cond=None, class_cond=None, generator=None)``
    with x (b, h, w, c) NHWC and sigma (b,); returns float32 (b, h, w, c).
    A model with ``num_classes`` takes ``class_cond`` (b,) int, whose
    embedding joins the mapping network's input. ``generator`` draws the
    dropout masks under ``model.train()``. Parameters are drawn from the
    constructor's ``generator``; the FourierFeatures bases too (the JAX
    package draws them from a fixed threefry key, which ``convert.py``
    carries across). Parameters go to ``device``, by default the card
    (``utils.default_device``); ``dtype`` is the compute dtype, by default
    bfloat16 on the card and float32 elsewhere (``utils.compute_dtype``)."""

    def __init__(self, levels, mapping, in_channels, out_channels, patch_size,
                 num_classes=0, dtype=None, device=None,
                 generator=None):
        super().__init__()
        device = default_device(device)
        dtype = compute_dtype(device, dtype)
        self.levels, self.dtype = levels, dtype
        self.num_classes = num_classes
        mw = mapping.width
        self.patch_in = TokenMerge(in_channels, levels[0].width, patch_size,
                                   dtype, generator, device)
        self.time_emb = FourierFeatures(1, mw, generator=generator,
                                        device=device)
        self.time_in_proj = _Kernel((mw, mw), "lecun", generator, device)
        self.aug_emb = FourierFeatures(9, mw, generator=generator,
                                       device=device)
        self.aug_in_proj = _Kernel((mw, mw), "lecun", generator, device)
        if num_classes:
            self.class_emb = _Embedding(num_classes, mw, generator, device)
        self.mapping = MappingNetwork(mapping.depth, mw, mapping.d_ff, dtype,
                                      generator, device, mapping.dropout)
        for prefix, spec in self._stacks():
            for j in range(spec.depth):
                self.add_module(f"{prefix}_layer_{j}", TransformerLayer(
                    spec, mw, dtype, generator, device))
        for i in range(len(levels) - 1):
            self.add_module(f"merge_{i}", TokenMerge(
                levels[i].width, levels[i + 1].width, (2, 2), dtype, generator,
                device))
            self.add_module(f"split_{i}", TokenSplit(
                levels[i + 1].width, levels[i].width, dtype, generator,
                device))
        self.out_norm = RMSNorm(levels[0].width, device=device)
        self.patch_out = TokenSplitWithoutSkip(
            levels[0].width, out_channels, patch_size, dtype, generator,
            device, zero_init=True)

    def _stacks(self):
        """(prefix, level spec) in execution order: down levels, mid, up."""
        down = [(f"down_{i}", s) for i, s in enumerate(self.levels[:-1])]
        up = [(f"up_{i}", s) for i, s in reversed(list(enumerate(
            self.levels[:-1])))]
        return down + [("mid", self.levels[-1])] + up

    def _run_stack(self, prefix, depth, x, pos, cond, generator):
        for j in range(depth):
            x = getattr(self, f"{prefix}_layer_{j}")(x, pos, cond, generator)
        return x

    def forward(self, x, sigma, aug_cond=None, class_cond=None,
                generator=None):
        if self.num_classes and class_cond is None:
            raise ValueError("class_cond must be specified if num_classes > 0")
        dtype = self.dtype
        x = self.patch_in(x.to(dtype))
        pos = rope.make_axial_pos(x.shape[-3], x.shape[-2], device=x.device)

        c_noise = torch.log(sigma.float()) / 4
        time_emb = (self.time_emb(c_noise[..., None]).to(dtype)
                    @ self.time_in_proj.kernel.to(dtype))
        if aug_cond is None:
            aug_cond = torch.zeros((sigma.shape[0], 9), dtype=dtype,
                                   device=x.device)
        aug_emb = (self.aug_emb(aug_cond.to(dtype)).to(dtype)
                   @ self.aug_in_proj.kernel.to(dtype))
        emb = time_emb + aug_emb
        if self.num_classes:
            emb = emb + self.class_emb.embedding.to(dtype)[class_cond]
        cond = self.mapping(emb, generator)

        skips, poses = [], []
        for i, spec in enumerate(self.levels[:-1]):
            x = self._run_stack(f"down_{i}", spec.depth, x, pos, cond,
                                generator)
            skips.append(x)
            poses.append(pos)
            x = getattr(self, f"merge_{i}")(x)
            pos = rope.downscale_pos(pos)
        x = self._run_stack("mid", self.levels[-1].depth, x, pos, cond,
                            generator)
        for i, spec in reversed(list(enumerate(self.levels[:-1]))):
            x = getattr(self, f"split_{i}")(x, skips[i])
            x = self._run_stack(f"up_{i}", spec.depth, x, poses[i], cond,
                                generator)

        x = self.patch_out(self.out_norm(x))
        return x.float()


# Param taxonomy: weight decay for the Dense kernels of these modules, the
# mapping network's params at a third of the LR (the JAX package's 4 groups)

_WD_MODULE_NAMES = {"qkv_proj", "out_proj", "up_proj", "down_proj", "proj",
                    "mapping_linear"}


def classify_param(name):
    """(is_wd, is_mapping) for a ``named_parameters()`` name, the JAX
    package's rule on its flattened param path."""
    path = name.split(".")
    is_wd = path[-1] == "kernel" and len(path) >= 2 and path[-2] in _WD_MODULE_NAMES
    is_mapping = any(p in ("mapping", "mapping_linear") for p in path)
    return is_wd, is_mapping


def param_group_labels(model):
    """{name: one of 'wd', 'no_wd', 'mapping_wd', 'mapping_no_wd'} over
    ``model.named_parameters()``."""
    labels = {}
    for name, _ in model.named_parameters():
        is_wd, is_mapping = classify_param(name)
        labels[name] = ("mapping_" if is_mapping else "") + ("wd" if is_wd else "no_wd")
    return labels
