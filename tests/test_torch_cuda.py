"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the flagship shapes are in chip_smoke.py). Every
test skips without a CUDA device. This file imports no JAX, so on a machine
without JAX run it past the JAX test harness in tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from k_diffusion_tpu_torch.ops import kernels, rope
from k_diffusion_tpu_torch.ops.kernels import (fused_ffn, fused_mapping,
                                               fused_qkv, global_packed, na2d)

# a few bf16 roundings of the output: the plain version rounds intermediates
# to bf16 where the kernel keeps f32 (the bound chip_smoke.py states)
REL_BOUND = 3e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def normal(gen, dev, *shape, std=1.0):
    return (torch.randn(shape, generator=gen) * std).to(dev, torch.bfloat16)


def unit_heads(gen, dev, *shape):
    t = torch.randn(shape, generator=gen).reshape(*shape[:-1], -1, 64)
    t = t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5
    return t.reshape(shape).to(dev, torch.bfloat16)


def assert_close(got, want):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_BOUND * want.float().abs().max().item(), err


def counted(module, fn):
    """fn()'s result; checks that it counted exactly one launch."""
    before = module.launches
    out = fn()
    assert module.launches == before + 1
    return out


@pytest.mark.parametrize("b,h,w,d", [(5, 4, 4, 128), (2, 16, 8, 256),
                                     (1, 8, 8, 512)])
def test_fused_qkv(dev, b, h, w, d):
    g = torch.Generator().manual_seed(0)
    heads = d // 64
    args = (normal(g, dev, b, h, w, d),
            rope.make_axial_pos(h, w, device=dev),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, torch.bfloat16),
            normal(g, dev, d, 3 * d, std=d ** -0.5),
            torch.full((heads,), 10.0, device=dev), heads)
    got = counted(fused_qkv, lambda: fused_qkv.fused_qkv_prologue(*args))
    for a, b_ in zip(got, fused_qkv.reference(*args)):
        assert_close(a, b_)


@pytest.mark.parametrize("b,h,w,heads,ks", [(2, 16, 24, 2, 7), (1, 8, 8, 4, 7),
                                            (1, 16, 16, 2, 3), (1, 24, 16, 1, 5)])
def test_na2d(dev, b, h, w, heads, ks):
    g = torch.Generator().manual_seed(1)
    c = heads * 64
    q, k = unit_heads(g, dev, b, h, w, c), unit_heads(g, dev, b, h, w, c)
    v = normal(g, dev, b, h, w, c)
    got = counted(na2d, lambda: na2d.na2d_packed(q, k, v, heads, ks))
    split = (b, h, w, heads, 64)
    want = na2d.na2d_reference(q.reshape(split), k.reshape(split),
                               v.reshape(split), ks).reshape(b, h, w, c)
    assert_close(got, want)


@pytest.mark.parametrize("b,s,heads", [(3, 16, 2), (2, 80, 8), (1, 512, 1)])
def test_global_packed(dev, b, s, heads):
    g = torch.Generator().manual_seed(2)
    c = heads * 64
    q, k = unit_heads(g, dev, b, s, c), unit_heads(g, dev, b, s, c)
    v = normal(g, dev, b, s, c)
    got = counted(global_packed, lambda: global_packed.packed_global_attention(
        q, k, v, heads))
    assert_close(got, global_packed.reference(q, k, v, heads))


@pytest.mark.parametrize("b,t,d,d_ff", [(3, 16, 128, 384), (2, 100, 256, 64)])
def test_fused_ffn(dev, b, t, d, d_ff):
    g = torch.Generator().manual_seed(3)
    args = (normal(g, dev, b, t, d),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, torch.bfloat16),
            normal(g, dev, d, 2 * d_ff, std=d ** -0.5),
            normal(g, dev, d_ff, d, std=d_ff ** -0.5))
    got = counted(fused_ffn, lambda: fused_ffn.fused_geglu_ffn(*args))
    assert_close(got, fused_ffn.reference(*args))


@pytest.mark.parametrize("b,d,d_ff,n", [(1, 256, 768, 2), (13, 128, 192, 3)])
def test_fused_mapping(dev, b, d, d_ff, n):
    g = torch.Generator().manual_seed(4)
    blocks = [((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
               torch.randn((d, 2 * d_ff), generator=g).to(dev) * d ** -0.5,
               torch.randn((d_ff, d), generator=g).to(dev) * d_ff ** -0.5)
              for _ in range(n)]
    args = (normal(g, dev, b, d), torch.ones(d, device=dev),
            torch.ones(d, device=dev), blocks)
    got = counted(fused_mapping, lambda: fused_mapping.fused_mapping(*args))
    assert_close(got, fused_mapping.reference(*args))


def test_wrappers_raise_instead_of_falling_back(dev):
    kernels.reset_launch_counts()
    x = torch.zeros((1, 12, 12, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        na2d.na2d_packed(x, x, x, 2, 7)
    with pytest.raises(ValueError, match="dtype"):
        na2d.na2d_packed(*(torch.zeros((1, 8, 8, 128), device=dev),) * 3, 2, 7)
    s = torch.zeros((1, 528, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 512"):
        global_packed.packed_global_attention(s, s, s, 1)
    x = torch.zeros((1, 8, 8, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64"):
        fused_qkv.fused_qkv_prologue(
            x, rope.make_axial_pos(8, 8, device=dev),
            torch.ones((1, 96), device=dev, dtype=torch.bfloat16),
            torch.zeros((96, 288), device=dev), torch.ones(3, device=dev), 3)
    assert kernels.launch_counts() == dict.fromkeys(kernels.MODULES, 0)
