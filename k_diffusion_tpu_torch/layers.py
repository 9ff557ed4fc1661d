"""Shared building blocks (counterpart of k_diffusion_tpu/layers.py)."""

import math

import torch
from torch import nn


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
