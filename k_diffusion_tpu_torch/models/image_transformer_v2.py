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

For condcache (``condcache.py``), ``cond_scale_layout`` packs every
AdaRMSNorm scale the forward derives from the mapping output into one
(b, total) row; ``forward(..., cond_only=True)`` returns the mapping output
and ``forward(..., cond_scales=row)`` takes each layer's scale as a (b, d)
view of the row, which the kernels read through its row stride, with no
copy. That path is forward-only.

Under ``model.train()`` each level's dropout applies where the JAX model
applies it: to the attention output before ``out_proj``, and to the GEGLU
hidden activation of the feed-forward blocks and the mapping network. A
block whose dropout is active runs the unfused plain chain (the fused
kernels contain no dropout), exactly as the JAX model routes. With
``KDT_TRAIN_FUSION=0`` (``ops.kernels.train_fusion_enabled``) training also
runs the attention prologue unfused, written out here, and every
feed-forward block unfused, as the JAX model does. Dropout masks are drawn
from the ``torch.Generator`` passed to ``forward``.

A level's attention is neighborhood (K2 or K11), global (K3 or K13),
shifted-window (PyTorch ops, ``ops.attention.shifted_window_attention``,
as the JAX package runs it on XLA; every other layer of a stack shifted)
or none (the layer is its feed-forward block). With ``checkpointing``
each selected ``TransformerLayer`` runs under
``torch.utils.checkpoint``; its recompute replays the dropout masks the
forward drew (``layers.remat``) and, under a ``save_*`` ``remat_policy``,
reads the attention kernels' kept outputs instead of launching them.
"""

import functools
from dataclasses import dataclass

import torch
from torch import nn

from ..layers import (NO_REMAT, FourierFeatures, check_remat_policy, dropout,
                      init_tensor, remat)
from ..ops import norms, rope
from ..ops.attention import shifted_window_attention
from ..ops.geglu import linear_geglu
from ..ops.kernels import global_packed, train_fusion_enabled
from ..ops.kernels.flash import flash_attention
from ..ops.kernels.fused_ffn import fused_geglu_ffn
from ..ops.kernels.fused_mapping import fused_mapping
from ..ops.kernels.fused_qkv import fused_qkv_prologue
from ..ops.kernels.fused_qkv import takes as prologue_takes
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
class ShiftedWindowAttentionSpec:
    d_head: int
    window_size: int


@dataclass(frozen=True)
class NoAttentionSpec:
    """A level whose layers have no attention block."""


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


def _stacks(levels):
    """(prefix, level spec) in execution order: down levels, mid, up."""
    down = [(f"down_{i}", s) for i, s in enumerate(levels[:-1])]
    up = [(f"up_{i}", s) for i, s in reversed(list(enumerate(levels[:-1])))]
    return down + [("mid", levels[-1])] + up


def cond_scale_layout(levels):
    """The lanes of the precomputed cond-scales row (``condcache.py``), a
    copy of the JAX package's: one scale per attention block and one per
    feed-forward block, in forward order (down levels, mid, up levels),
    each level's run aligned up to a multiple of its width (the padding
    lanes are written and never read). Returns ({layer name: (attn_off,
    ff_off)}, total), with attn_off None for a level with no attention."""
    table, off = {}, 0
    for prefix, spec in _stacks(levels):
        has_attn = not isinstance(spec.self_attn, NoAttentionSpec)
        off = -(-off // spec.width) * spec.width  # align to width
        for j in range(spec.depth):
            attn_off = None
            if has_attn:
                attn_off = off
                off += spec.width
            table[f"{prefix}_layer_{j}"] = (attn_off, off)
            off += spec.width
    return table, off


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
    """AdaRMSNorm -> qkv -> cosine-sim + RoPE (kernel K1) -> neighborhood,
    global or shifted-window attention -> dropout -> out projection ->
    residual.

    The prologue runs unfused (written out here, plain torch on the card)
    in training with ``KDT_TRAIN_FUSION=0``, as the JAX model's does, and
    wherever ``fused_qkv.takes`` is false (a head dim other than 32 or 64:
    the JAX dispatcher runs its plain chain there). A neighborhood level
    goes to the channel-packed K2 where ``na2d.packed_takes`` its width and
    head dim and the prologue ran fused, and to the per-head K11 otherwise
    (the unfused prologue, a level wider than 512 or not a multiple of 128,
    a head dim other than 64). A
    global level goes to K3 where ``global_packed.takes`` it (head dim 64,
    s a multiple of 16 up to 512) and to the flash kernel K13 otherwise. A
    shifted-window level attends within windows of the map, rolled by half
    a window where ``shifted``."""

    def __init__(self, d_model, attn_spec, cond_features, dtype, generator,
                 device, dropout=0.0, shifted=False):
        super().__init__()
        self.d_model, self.attn_spec, self.dtype = d_model, attn_spec, dtype
        self.dropout, self.shifted = dropout, shifted
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

    def forward(self, x, pos, cond, generator=None, norm_scale=None):
        """``norm_scale``: this block's precomputed AdaRMSNorm scale (a
        (b, d) view of a condcache row), which replaces norm(cond)."""
        b, h, w, c = x.shape
        e = self.attn_spec.d_head
        if norm_scale is None:
            norm_scale = self.norm(cond, self.dtype)
        fused = (not self.training or train_fusion_enabled()) and \
            prologue_takes(c, self.n_heads)
        if fused:
            q, k, v = (t.reshape(b, h, w, self.n_heads, e)
                       for t in fused_qkv_prologue(
                           x, pos, norm_scale, self.qkv_proj.kernel,
                           self.scale, self.n_heads))
        else:
            q, k, v = self._unfused_prologue(x, pos, norm_scale)
        if isinstance(self.attn_spec, ShiftedWindowAttentionSpec):
            ws = self.attn_spec.window_size
            out = shifted_window_attention(q, k, v, ws,
                                           ws // 2 if self.shifted else 0,
                                           scale=1.0)
        elif isinstance(self.attn_spec, GlobalAttentionSpec):
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

    def forward(self, x, cond, generator=None, scale=None):
        """``scale``: as SelfAttentionBlock's ``norm_scale``."""
        b, h, w, d = x.shape
        if scale is None:
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
    """Attention (none on a ``NoAttentionSpec`` level) and feed-forward:
    the unit of gradient checkpointing."""

    def __init__(self, spec, cond_features, dtype, generator, device,
                 shifted=False):
        super().__init__()
        if not isinstance(spec.self_attn, NoAttentionSpec):
            self.self_attn = SelfAttentionBlock(
                spec.width, spec.self_attn, cond_features, dtype, generator,
                device, spec.dropout, shifted)
        self.ff = FeedForwardBlock(spec.width, spec.d_ff, cond_features,
                                   generator, device, spec.dropout)

    def forward(self, x, pos, cond, generator=None, scales=(None, None)):
        """``scales``: the attention and feed-forward blocks' precomputed
        AdaRMSNorm scales, or None each."""
        if hasattr(self, "self_attn"):
            x = self.self_attn(x, pos, cond, generator, scales[0])
        return self.ff(x, cond, generator, scales[1])


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

    ``model(x, sigma, aug_cond=None, class_cond=None, mapping_cond=None,
    generator=None)`` with x (b, h, w, c) NHWC and sigma (b,); returns
    float32 (b, h, w, c). A model with ``num_classes`` takes ``class_cond``
    (b,) int, whose embedding joins the mapping network's input, and one
    with ``mapping_cond_dim`` takes ``mapping_cond``. ``generator`` draws
    the dropout masks under ``model.train()``. ``checkpointing`` runs the
    layers of the stacks that ``remat_levels`` selects (default: all)
    under ``torch.utils.checkpoint`` in training, keeping what
    ``remat_policy`` names (``layers.REMAT_POLICIES``: the JAX model's
    ``save_*`` policies keep the attention kernels' outputs, so that the
    recompute launches no attention forward; "everything_saveable" runs
    no checkpoint). Parameters are drawn from the
    constructor's ``generator``; the FourierFeatures bases too (the JAX
    package draws them from a fixed threefry key, which ``convert.py``
    carries across). Parameters go to ``device``, by default the card
    (``utils.default_device``); ``dtype`` is the compute dtype, by default
    bfloat16 on the card and float32 elsewhere (``utils.compute_dtype``);
    on the card bfloat16 or float32."""

    def __init__(self, levels, mapping, in_channels, out_channels, patch_size,
                 num_classes=0, mapping_cond_dim=0, checkpointing=False,
                 remat_policy=None, remat_levels=None, dtype=None,
                 device=None, generator=None):
        super().__init__()
        check_remat_policy(remat_policy)
        device = default_device(device)
        dtype = compute_dtype(device, dtype)
        self.levels, self.dtype = levels, dtype
        self.num_classes, self.mapping_cond_dim = num_classes, mapping_cond_dim
        self.checkpointing = checkpointing and remat_policy != NO_REMAT
        self.remat_policy = remat_policy
        self.remat_levels = None if remat_levels is None else tuple(remat_levels)
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
        if mapping_cond_dim:
            self.mapping_cond_in_proj = _Kernel((mapping_cond_dim, mw),
                                                "lecun", generator, device)
        self.mapping = MappingNetwork(mapping.depth, mw, mapping.d_ff, dtype,
                                      generator, device, mapping.dropout)
        for prefix, spec in _stacks(levels):
            # layer j of a stack is shifted where j + offset is odd, the
            # up stacks offset by the level's depth, as the JAX model does
            offset = spec.depth if prefix.startswith("up") else 0
            for j in range(spec.depth):
                self.add_module(f"{prefix}_layer_{j}", TransformerLayer(
                    spec, mw, dtype, generator, device,
                    shifted=(j + offset) % 2 == 1))
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

    def _remats(self, prefix, level):
        """Whether the layers of stack ``prefix`` of level ``level`` run
        under checkpointing: all of them with ``checkpointing``, unless
        ``remat_levels`` names neither the level's index (both its down and
        up stacks) nor the stack ("down_0", "mid", "up_1")."""
        if not self.checkpointing:
            return False
        return (self.remat_levels is None or level in self.remat_levels
                or prefix in self.remat_levels)

    def _run_stack(self, prefix, level, depth, x, pos, cond, generator,
                   scales):
        checkpointed = (self._remats(prefix, level)
                        and torch.is_grad_enabled())
        for j in range(depth):
            name = f"{prefix}_layer_{j}"
            layer, sc = getattr(self, name), scales.get(name, (None, None))
            if checkpointed:
                x = remat(functools.partial(layer, scales=sc), generator, x,
                          pos, cond, policy=self.remat_policy)
            else:
                x = layer(x, pos, cond, generator, sc)
        return x

    def _layer_scales(self, cond_scales):
        """{layer name: (attn scale, ff scale)}: (b, d) views of the
        (b, total) row ``cond_scales``, no copies."""
        layout, total = cond_scale_layout(self.levels)
        if cond_scales.ndim != 2 or cond_scales.shape[-1] != total:
            raise ValueError(f"cond_scales has shape {tuple(cond_scales.shape)}"
                             f"; the layout takes (batch, {total})")
        cond_scales = cond_scales.to(self.dtype)
        widths = {name: spec.width for prefix, spec in _stacks(self.levels)
                  for name in (f"{prefix}_layer_{j}"
                               for j in range(spec.depth))}
        return {name: tuple(None if off is None
                            else cond_scales[:, off:off + widths[name]]
                            for off in offs)
                for name, offs in layout.items()}

    def forward(self, x, sigma, aug_cond=None, class_cond=None,
                mapping_cond=None, generator=None, cond_scales=None,
                cond_only=False):
        """``mapping_cond`` (b, mapping_cond_dim) joins the mapping
        network's input through ``mapping_cond_in_proj``. ``cond_only``:
        return the mapping network's output (b, width) and run no image
        path (``x`` may be None). ``cond_scales``: the step's condcache row
        (b, total), holding every layer's AdaRMSNorm scale and with them
        the conditioning they were made from, so that ``sigma`` and the
        mapping network are not read; forward-only, and it takes no
        ``aug_cond``, ``class_cond`` or ``mapping_cond``."""
        scales = {}
        if cond_scales is not None:
            if (aug_cond is not None or class_cond is not None
                    or mapping_cond is not None):
                raise ValueError(
                    "cond_scales holds the conditioning it was made from; "
                    "pass aug_cond, class_cond and mapping_cond to "
                    "condcache.precompute_cond_scales, not with cond_scales")
            if torch.is_grad_enabled():
                raise RuntimeError(
                    "cond_scales is a sampling path, forward-only: run it "
                    "under torch.no_grad()")
            scales = self._layer_scales(cond_scales)
        elif self.num_classes and class_cond is None:
            raise ValueError("class_cond must be specified if num_classes > 0")
        elif self.mapping_cond_dim and mapping_cond is None:
            raise ValueError(
                "mapping_cond must be specified if mapping_cond_dim > 0")
        dtype = self.dtype
        cond = None if cond_scales is not None else self._cond(
            sigma, aug_cond, class_cond, mapping_cond, generator)
        if cond_only:
            return cond
        x = self.patch_in(x.to(dtype))
        pos = rope.make_axial_pos(x.shape[-3], x.shape[-2], device=x.device)

        skips, poses = [], []
        for i, spec in enumerate(self.levels[:-1]):
            x = self._run_stack(f"down_{i}", i, spec.depth, x, pos, cond,
                                generator, scales)
            skips.append(x)
            poses.append(pos)
            x = getattr(self, f"merge_{i}")(x)
            pos = rope.downscale_pos(pos)
        x = self._run_stack("mid", len(self.levels) - 1,
                            self.levels[-1].depth, x, pos, cond, generator,
                            scales)
        for i, spec in reversed(list(enumerate(self.levels[:-1]))):
            x = getattr(self, f"split_{i}")(x, skips[i])
            x = self._run_stack(f"up_{i}", i, spec.depth, x, poses[i], cond,
                                generator, scales)

        x = self.patch_out(self.out_norm(x))
        return x.float()

    def _cond(self, sigma, aug_cond, class_cond, mapping_cond, generator):
        """The mapping network's output for noise level ``sigma``."""
        dtype = self.dtype
        device = self.time_in_proj.kernel.device
        c_noise = torch.log(sigma.float()) / 4
        time_emb = (self.time_emb(c_noise[..., None]).to(dtype)
                    @ self.time_in_proj.kernel.to(dtype))
        if aug_cond is None:
            aug_cond = torch.zeros((sigma.shape[0], 9), dtype=dtype,
                                   device=device)
        aug_emb = (self.aug_emb(aug_cond.to(dtype)).to(dtype)
                   @ self.aug_in_proj.kernel.to(dtype))
        emb = time_emb + aug_emb
        if self.num_classes:
            emb = emb + self.class_emb.embedding.to(dtype)[class_cond]
        if self.mapping_cond_dim:
            emb = emb + (mapping_cond.to(dtype)
                         @ self.mapping_cond_in_proj.kernel.to(dtype))
        return self.mapping(emb, generator)


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
