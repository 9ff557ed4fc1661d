"""GEGLU activation (counterpart of k_diffusion_tpu/ops/geglu.py)."""

import torch.nn.functional as F


def linear_geglu(x, weight):
    """x @ weight -> split halves -> a * gelu(gate), exact erf GELU.
    ``weight`` is (in_features, out_features * 2)."""
    a, gate = (x @ weight).chunk(2, dim=-1)
    return a * F.gelu(gate, approximate="none")
