"""The port's CUDA kernels, forward and backward, against their plain
PyTorch versions on the card, at small and ragged shapes (the flagship
shapes are in chip_smoke.py). Every test is marked ``cuda`` and skips
without a CUDA device. This file imports no JAX, so on a machine without JAX
run it past the JAX test harness in tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from k_diffusion_tpu_torch.ops import kernels, rope
from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d
from k_diffusion_tpu_torch.ops.kernels import (flash, fused_ffn, fused_mapping,
                                               fused_qkv, global_packed, na2d)

pytestmark = pytest.mark.cuda

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


def unit_heads(gen, dev, *shape, e=64):
    t = torch.randn(shape, generator=gen).reshape(*shape[:-1], -1, e)
    t = t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5
    return t.reshape(shape).to(dev, torch.bfloat16)


def assert_close(got, want):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_BOUND * want.float().abs().max().item(), err


def assert_all_close(got, want):
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and a.shape == b_.shape
        assert_close(a, b_)


def counted(module, fn, counter="launches"):
    """fn()'s result; checks that it counted exactly one launch."""
    before = getattr(module, counter)
    out = fn()
    assert getattr(module, counter) == before + 1
    return out


def qkv_args(g, dev, b, h, w, d):
    heads = d // 64
    return (normal(g, dev, b, h, w, d), rope.make_axial_pos(h, w, device=dev),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, torch.bfloat16),
            torch.randn((d, 3 * d), generator=g).to(dev) * d ** -0.5,
            10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev), heads)


def ffn_args(g, dev, b, t, d, d_ff):
    return (normal(g, dev, b, t, d),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, torch.bfloat16),
            torch.randn((d, 2 * d_ff), generator=g).to(dev) * d ** -0.5,
            torch.randn((d_ff, d), generator=g).to(dev) * d_ff ** -0.5)


@pytest.mark.parametrize("b,h,w,d", [(5, 4, 4, 128), (2, 16, 8, 256),
                                     (1, 8, 8, 512), (2, 7, 7, 128),
                                     (1, 10, 10, 256), (2, 7, 7, 192),
                                     (2, 16, 16, 768)])
def test_fused_qkv(dev, b, h, w, d):
    """K1: 4 x 4, 7 x 7 and 10 x 10 maps leave a 64-row tile ragged; d = 192
    takes one W panel a ring step (3d / 64 odd); d = 768 is config_512_hdit's
    12-head level."""
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


# (b, h, w, heads, ks) of the NA forward: one tile, h != w, and maps with
# interior tiles (32 x 32, 40 x 24: at ks = 7 the first streamed halo tile
# of an interior query tile holds no key of its rows 4-7, the last none of
# its rows 0-3), at every odd kernel size
NA_FWD_CASES = [(2, 16, 24, 2, 7), (1, 8, 8, 4, 7), (1, 16, 16, 2, 3),
                (1, 24, 16, 1, 5)] + [
    (1, h, w, 2, ks) for h, w in ((8, 8), (16, 24), (32, 32))
    for ks in (1, 3, 5, 7)] + [(2, 40, 24, 1, 7), (2, 32, 32, 4, 7)]


def na_logsumexp(q, k, ks):
    """The f32 logsumexp of each query's masked logits, (b, heads, h, w),
    from (b, h, w, heads, e) q and k: what the NA forwards save."""
    b, h, w, heads, e = q.shape
    logits = torch.einsum("bqne,bkne->bnqk",
                          q.float().reshape(b, h * w, heads, e),
                          k.float().reshape(b, h * w, heads, e))
    mask = neighborhood_mask_2d(h, w, ks, q.device)
    return torch.logsumexp(logits.masked_fill(~mask, float("-inf")),
                           -1).reshape(b, heads, h, w)


@pytest.mark.parametrize("b,h,w,heads,ks", NA_FWD_CASES)
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


@pytest.mark.parametrize("b,h,w,heads,ks", NA_FWD_CASES)
def test_na2d_forward_lse(dev, b, h, w, heads, ks):
    """K2's training forward: out as without the lse, and the logsumexp K7
    reads against the f32 masked logits."""
    g = torch.Generator().manual_seed(23)
    c = heads * 64
    q, k = unit_heads(g, dev, b, h, w, c), unit_heads(g, dev, b, h, w, c)
    v = normal(g, dev, b, h, w, c)
    out, lse = counted(na2d, lambda: na2d.packed_forward(q, k, v, heads, ks,
                                                         save_lse=True))
    assert lse.shape == (b, heads, h, w) and lse.dtype == torch.float32
    assert torch.equal(out, na2d.packed_forward(q, k, v, heads, ks)[0])
    split = (b, h, w, heads, 64)
    assert_close(lse, na_logsumexp(q.reshape(split), k.reshape(split), ks))


@pytest.mark.parametrize("b,h,w,heads,ks", [(8, 32, 32, 4, 7), (2, 16, 24, 2, 7),
                                            (1, 40, 24, 1, 3), (1, 8, 8, 2, 1)])
def test_na2d_packed_and_heads_agree_bit_for_bit(dev, b, h, w, heads, ks):
    """K2 and K11 run one forward (csrc/na_fwd.cuh): on one contiguous packed
    input at head dim 64, read by K11 as its (b, h, w, heads, 64) view, they
    give the same out and lse bit for bit."""
    g = torch.Generator().manual_seed(24)
    c = heads * 64
    q, k = unit_heads(g, dev, b, h, w, c), unit_heads(g, dev, b, h, w, c)
    v = normal(g, dev, b, h, w, c)
    out, lse = na2d.packed_forward(q, k, v, heads, ks, save_lse=True)
    split = [t.reshape(b, h, w, heads, 64) for t in (q, k, v)]
    out11, lse11 = na2d.heads_forward(*split, ks, save_lse=True)
    assert torch.equal(out, out11.reshape(b, h, w, c))
    assert torch.equal(lse, lse11)


@pytest.mark.parametrize("b,s,heads", [(3, 16, 2), (2, 80, 8), (1, 512, 1)])
def test_global_packed(dev, b, s, heads):
    g = torch.Generator().manual_seed(2)
    c = heads * 64
    q, k = unit_heads(g, dev, b, s, c), unit_heads(g, dev, b, s, c)
    v = normal(g, dev, b, s, c)
    got = counted(global_packed, lambda: global_packed.packed_global_attention(
        q, k, v, heads))
    assert_close(got, global_packed.reference(q, k, v, heads))


@pytest.mark.parametrize("b,t,d,d_ff", [(3, 16, 128, 384), (2, 100, 256, 64),
                                        (1, 64, 512, 1536), (2, 1024, 256, 768),
                                        (1, 49, 256, 768), (2, 49, 768, 2304),
                                        (3, 64, 64, 128), (2, 100, 192, 384),
                                        (8, 4096, 128, 384)])
def test_fused_ffn(dev, b, t, d, d_ff):
    """K4: ragged row tiles (16, 49 and 100 tokens), d_ff of one panel,
    config_512_hdit's d = 512 and d = 768 levels (two and three column
    groups), 2 x 1024 rows, 1 to 4 output tiles a block (d = 64, 128, 192,
    256), and the flagship's level 0, where a cluster is one block."""
    g = torch.Generator().manual_seed(3)
    args = (normal(g, dev, b, t, d),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, torch.bfloat16),
            normal(g, dev, d, 2 * d_ff, std=d ** -0.5),
            normal(g, dev, d_ff, d, std=d_ff ** -0.5))
    got = counted(fused_ffn, lambda: fused_ffn.fused_geglu_ffn(*args))
    assert_close(got, fused_ffn.reference(*args))


@pytest.mark.parametrize("b,d,d_ff,n", [(1, 256, 768, 2), (13, 128, 192, 3),
                                        (32, 256, 768, 2), (33, 256, 768, 2),
                                        (64, 768, 2048, 2), (5, 512, 1408, 3)])
def test_fused_mapping(dev, b, d, d_ff, n):
    """The last two are the ViT's widths, whose layer shares stream through
    the kernel's ring (``fused_mapping.layout``)."""
    g = torch.Generator().manual_seed(4)
    blocks = [((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
               torch.randn((d, 2 * d_ff), generator=g).to(dev) * d ** -0.5,
               torch.randn((d_ff, d), generator=g).to(dev) * d_ff ** -0.5)
              for _ in range(n)]
    args = (normal(g, dev, b, d), torch.ones(d, device=dev),
            torch.ones(d, device=dev), blocks)
    got = counted(fused_mapping, lambda: fused_mapping.fused_mapping(*args))
    assert_close(got, fused_mapping.reference(*args))


@pytest.mark.parametrize("b,d,d_ff,n", [(8, 256, 768, 2), (33, 256, 768, 2),
                                        (3, 128, 192, 3), (5, 64, 1024, 1),
                                        (8, 256, 768, 5), (17, 768, 2048, 2),
                                        (8, 1024, 2752, 1)])
def test_fused_mapping_bf16_weights(dev, b, d, d_ff, n):
    """K5 reads bf16 weights as they come, as it reads f32 ones; d_ff =
    1024 leaves its 64 panels unevenly over 16 ranks; at depth 5 the
    layers' weight shares do not all fit, and later layers load into the
    buffers earlier ones are done with; at d = 768 and 1024 not one share
    fits, and they stream through the ring; a rerun is bit-equal (the
    partials meet in a fixed order)."""
    g = torch.Generator().manual_seed(25)
    blocks = [((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
               normal(g, dev, d, 2 * d_ff, std=d ** -0.5),
               normal(g, dev, d_ff, d, std=d_ff ** -0.5)) for _ in range(n)]
    args = (normal(g, dev, b, d), torch.ones(d, device=dev),
            torch.ones(d, device=dev), blocks)
    got = counted(fused_mapping, lambda: fused_mapping.fused_mapping(*args))
    assert_close(got, fused_mapping.reference(*args))
    assert torch.equal(got, fused_mapping.fused_mapping(*args))
    # the same weights as float32 round to the same bf16 values in the kernel
    f32 = [(ns, wu.float(), wd.float()) for ns, wu, wd in blocks]
    assert torch.equal(got, fused_mapping.fused_mapping(*args[:3], f32))


def test_fused_mapping_launches_one_kernel(dev):
    """The wrapper launches the kernel and nothing else (no stack, no cast)
    with the model's float32 params."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(26)
    blocks = [((1 + 0.1 * torch.randn(256, generator=g)).to(dev),
               torch.randn((256, 1536), generator=g).to(dev) * 256 ** -0.5,
               torch.randn((768, 256), generator=g).to(dev) * 768 ** -0.5)
              for _ in range(2)]
    args = (normal(g, dev, 8, 256), torch.ones(256, device=dev),
            torch.ones(256, device=dev), blocks)
    fused_mapping.fused_mapping(*args)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_mapping.fused_mapping(*args)
        torch.cuda.synchronize()
    kernels_run = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels_run) == 1 and "mapping_kernel" in kernels_run[0].name


@pytest.mark.parametrize("b,h,w,d", [(2, 8, 8, 128), (3, 4, 4, 256),
                                     (1, 16, 8, 512), (1, 16, 16, 768),
                                     (2, 64, 64, 128)])
def test_fused_qkv_backward(dev, b, h, w, d):
    """K6 against autograd through the plain version; 4 x 4 maps leave a
    64-row tile ragged; d = 768 is config_512_hdit's 12-head level, and
    2 x 64 x 64 splits the weight gradient's rows into several chunks."""
    g = torch.Generator().manual_seed(5)
    args = qkv_args(g, dev, b, h, w, d)
    cots = [normal(g, dev, b, h, w, d) for _ in range(3)]
    got = counted(fused_qkv, lambda: fused_qkv.prologue_backward(*args, *cots),
                  "bwd_launches")
    assert_all_close(got, fused_qkv.reference_backward(*args, *cots))


@pytest.mark.parametrize("b,h,w,heads,ks", [(2, 16, 24, 2, 7), (1, 8, 8, 4, 7),
                                            (1, 16, 16, 2, 3), (1, 24, 16, 1, 3),
                                            (1, 24, 16, 1, 5), (2, 64, 64, 2, 7),
                                            (2, 32, 32, 4, 7), (1, 16, 8, 2, 1),
                                            (1, 8, 24, 1, 1)])
def test_na2d_backward(dev, b, h, w, heads, ks):
    """K7 (its dq kernel and its dk/dv kernel) against autograd through the
    plain version: h != w, clamped windows of several sizes, kernel size 1,
    and the flagship's two NA levels at batch 2; a rerun gives bit-equal
    gradients (no partials, no atomics)."""
    g = torch.Generator().manual_seed(6)
    c = heads * 64
    q, k = unit_heads(g, dev, b, h, w, c), unit_heads(g, dev, b, h, w, c)
    v, dout = normal(g, dev, b, h, w, c), normal(g, dev, b, h, w, c)
    out, lse = na2d.packed_forward(q, k, v, heads, ks, save_lse=True)
    got = counted(na2d, lambda: na2d.packed_backward(q, k, v, out, lse, dout,
                                                     heads, ks), "bwd_launches")
    want = na2d.reference_backward(q, k, v, dout, heads, ks)
    if ks == 1:
        # a window of one key: the softmax has no gradient in its logit, so
        # the plain dq and dk are exactly 0, and the kernel's hold only the
        # f32 rounding of dP - delta (one dot product summed in two
        # orders): they are held to the bound on the scale of dv, dout
        assert all(a.dtype == b_.dtype and a.shape == b_.shape
                   and not b_.any() for a, b_ in zip(got[:2], want[:2]))
        scale = want[2].float().abs().max().item()
        assert all(a.float().abs().max().item() <= REL_BOUND * scale
                   for a in got[:2])
        assert_close(got[2], want[2])
    else:
        assert_all_close(got, want)
    again = na2d.packed_backward(q, k, v, out, lse, dout, heads, ks)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("b,h,w,heads,ks", [(2, 16, 24, 2, 7), (1, 24, 16, 1, 3)])
def test_na2d_overlap_add(dev, b, h, w, heads, ks):
    """K8 alone against its plain overlap-add of the same plain per-tile
    halo partials."""
    g = torch.Generator().manual_seed(11)
    c = heads * 64
    q, k = unit_heads(g, dev, b, h, w, c), unit_heads(g, dev, b, h, w, c)
    v, dout = normal(g, dev, b, h, w, c), normal(g, dev, b, h, w, c)
    dk_part, dv_part = na2d.packed_backward_partials_reference(q, k, v, dout,
                                                               heads, ks)
    got = counted(na2d, lambda: na2d.overlap_add(dk_part, dv_part, h, w, ks),
                  "overlap_launches")
    assert_all_close(got, na2d.overlap_add_reference(dk_part, dv_part, h, w,
                                                     ks))


@pytest.mark.parametrize("b,s,heads", [(3, 16, 2), (2, 48, 2), (2, 80, 8),
                                       (1, 512, 1), (2, 512, 4)])
def test_global_packed_backward(dev, b, s, heads):
    """K9 against autograd through the plain version, s below one 64-row
    block and ragged; a rerun gives bit-equal gradients (no atomics)."""
    g = torch.Generator().manual_seed(7)
    c = heads * 64
    q, k = unit_heads(g, dev, b, s, c), unit_heads(g, dev, b, s, c)
    v, dout = normal(g, dev, b, s, c), normal(g, dev, b, s, c)
    out, lse = global_packed.packed_forward(q, k, v, heads, save_lse=True)
    assert_close(lse, torch.logsumexp(
        torch.einsum("bqhe,bkhe->bhqk", *(t.float().reshape(b, s, heads, 64)
                                          for t in (q, k))), -1))
    got = counted(global_packed, lambda: global_packed.packed_backward(
        q, k, v, out, lse, dout, heads), "bwd_launches")
    assert_all_close(got, global_packed.reference_backward(q, k, v, dout, heads))
    again = global_packed.packed_backward(q, k, v, out, lse, dout, heads)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("b,s,heads,scale", [(8, 256, 8, 1.0), (3, 16, 2, 1.0),
                                             (2, 80, 4, 0.125)])
def test_global_packed_and_flash_backward_agree_bit_for_bit(dev, b, s, heads,
                                                            scale):
    """K9 and K14 share their kernels (csrc/attn_bwd.cuh): on one contiguous
    packed input at head dim 64, with the same out and lse, they give the
    same dq, dk, dv bit for bit."""
    g = torch.Generator().manual_seed(20)
    c = heads * 64
    q, k = unit_heads(g, dev, b, s, c), unit_heads(g, dev, b, s, c)
    v, dout = normal(g, dev, b, s, c), normal(g, dev, b, s, c)
    out, lse = global_packed.packed_forward(q, k, v, heads, scale,
                                            save_lse=True)
    packed = global_packed.packed_backward(q, k, v, out, lse, dout, heads,
                                           scale)
    split = [t.reshape(b, s, heads, 64) for t in (q, k, v, out, dout)]
    strided = flash.flash_backward(*split[:4], lse, split[4], scale)
    for a, b_ in zip(packed, strided):
        assert torch.equal(a, b_.reshape(b, s, c))


@pytest.mark.parametrize("b,s,heads", [(8, 256, 8), (3, 16, 2), (2, 208, 4),
                                       (1, 512, 1)])
def test_global_packed_forward_lse(dev, b, s, heads):
    """K3's training forward: out and the logsumexp K9 reads against the
    plain versions (``reference``, ``reference_lse``)."""
    g = torch.Generator().manual_seed(21)
    c = heads * 64
    q, k = unit_heads(g, dev, b, s, c), unit_heads(g, dev, b, s, c)
    v = normal(g, dev, b, s, c)
    out, lse = counted(global_packed, lambda: global_packed.packed_forward(
        q, k, v, heads, save_lse=True))
    assert lse.shape == (b, heads, s) and lse.dtype == torch.float32
    assert_close(out, global_packed.reference(q, k, v, heads))
    assert_close(lse, global_packed.reference_lse(q, k, v, heads))


@pytest.mark.parametrize("b,s,heads,scale", [(8, 256, 8, 1.0), (3, 16, 2, 1.0),
                                             (2, 80, 4, 0.125)])
def test_global_packed_and_flash_forward_agree_bit_for_bit(dev, b, s, heads,
                                                           scale):
    """K3 and K13 run one kernel (csrc/attn_fwd.cuh): on one contiguous
    packed input at head dim 64 they give the same out and lse bit for bit,
    with and without the lse."""
    g = torch.Generator().manual_seed(22)
    c = heads * 64
    q, k = unit_heads(g, dev, b, s, c), unit_heads(g, dev, b, s, c)
    v = normal(g, dev, b, s, c)
    split = [t.reshape(b, s, heads, 64) for t in (q, k, v)]
    for save_lse in (True, False):
        out, lse = global_packed.packed_forward(q, k, v, heads, scale,
                                                save_lse=save_lse)
        out2, lse2 = flash.flash_forward(*split, scale, save_lse=save_lse)
        assert torch.equal(out, out2.reshape(b, s, c))
        assert (lse is None and lse2 is None) or torch.equal(lse, lse2)


@pytest.mark.parametrize("b,t,d,d_ff", [(3, 16, 128, 384), (2, 100, 256, 64),
                                        (1, 64, 512, 1536), (2, 1024, 256, 768),
                                        (1, 49, 256, 768)])
def test_fused_ffn_backward(dev, b, t, d, d_ff):
    """K10 against autograd through the plain version: ragged row tiles
    (16, 100 and 49 tokens), d_ff of one panel, config_512_hdit's d = 512
    level, and 2 x 1024 rows in several weight-gradient chunks."""
    g = torch.Generator().manual_seed(8)
    args = ffn_args(g, dev, b, t, d, d_ff)
    cot = normal(g, dev, b, t, d)
    got = counted(fused_ffn, lambda: fused_ffn.ffn_backward(*args, cot),
                  "bwd_launches")
    assert_all_close(got, fused_ffn.reference_backward(*args, cot))


# (b, s, heads, scale): the mnist models' 7 x 7 level at the HDiT's scale 1,
# the U-Net's 8 x 8 and 16 x 16 levels at 1/8, a 32 x 32 level, one token,
# and ragged lengths below and above one 64-row tile
FLASH_CASES = [(2, 49, 4, 1.0), (3, 64, 8, 0.125), (2, 256, 4, 0.125),
               (1, 1024, 2, 0.125), (2, 1, 1, 0.125), (1, 100, 3, 0.125)]


def flash_qkv(g, dev, b, s, heads, scale, e=64):
    """q, k, v as the U-Net makes them, strided views of one (b, s, 3, heads,
    e) projection, and a cotangent; logits of about unit spread at either
    scale."""
    qkv = normal(g, dev, b, s, 3, heads, e, std=(0.125 / scale * 64 / e) ** 0.5)
    return (*qkv.unbind(2), normal(g, dev, b, s, heads, e))


@pytest.mark.parametrize("b,s,heads,scale", FLASH_CASES)
def test_flash(dev, b, s, heads, scale):
    """K13 on strided q, k, v; its logsumexp against the f32 logits."""
    g = torch.Generator().manual_seed(12)
    q, k, v, _ = flash_qkv(g, dev, b, s, heads, scale)
    assert not q.is_contiguous()
    got = counted(flash, lambda: flash.flash_attention(q, k, v, scale))
    assert_close(got, flash.reference(q, k, v, scale))
    out, lse = flash.flash_forward(q, k, v, scale, save_lse=True)
    assert torch.equal(out, got)
    logits = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) * scale
    assert_close(lse, torch.logsumexp(logits, -1))


@pytest.mark.parametrize("b,s,heads,e", [(2, s, 3, e) for e in (64, 32)
                                         for s in (1, 49, 65, 200)]
                         + [(3, 256, 4, 64)])
def test_flash_forward_lse(dev, b, s, heads, e):
    """K13's training forward on strided q, k, v: out and the logsumexp K14
    reads against the plain versions (``reference``, ``reference_lse``),
    the last key tile ragged at s = 1, 49, 65 and 200."""
    g = torch.Generator().manual_seed(23)
    q, k, v, _ = flash_qkv(g, dev, b, s, heads, 0.125, e)
    out, lse = counted(flash, lambda: flash.flash_forward(q, k, v, 0.125,
                                                          save_lse=True))
    assert lse.shape == (b, heads, s) and lse.dtype == torch.float32
    assert_close(out, flash.reference(q, k, v, 0.125))
    assert_close(lse, flash.reference_lse(q, k, v, 0.125))


@pytest.mark.parametrize("b,s,heads,scale",
                         [c for c in FLASH_CASES if c[1] > 1])
def test_flash_backward(dev, b, s, heads, scale):
    """K14 against autograd through the plain version; a rerun gives
    bit-equal gradients (no atomics)."""
    g = torch.Generator().manual_seed(13)
    q, k, v, dout = flash_qkv(g, dev, b, s, heads, scale)
    out, lse = flash.flash_forward(q, k, v, scale, save_lse=True)
    got = counted(flash, lambda: flash.flash_backward(q, k, v, out, lse, dout,
                                                      scale), "bwd_launches")
    assert_all_close(got, flash.reference_backward(q, k, v, dout, scale))
    again = flash.flash_backward(q, k, v, out, lse, dout, scale)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


def test_flash_backward_of_one_token(dev):
    """With one key, p = 1: dv = dout, and dq and dk vanish up to the f32
    rounding of dp - delta (the plain version's are exactly 0)."""
    g = torch.Generator().manual_seed(14)
    q, k, v, dout = flash_qkv(g, dev, 3, 1, 2, 0.125)
    out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
    dq, dk, dv = flash.flash_backward(q, k, v, out, lse, dout, 0.125)
    assert torch.equal(dv, dout)
    top = dout.float().abs().max().item()
    for t in (dq, dk):
        assert t.float().abs().max().item() <= 1e-5 * top


# K13 and K14 in float32 against the plain version in float32 with TF32 off:
# the kernels round the products' operands to TF32 (10 mantissa bits), the
# bound chip_smoke.py states
F32_REL_BOUND = 5e-3


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("b,s,heads,e", [(2, s, 3, e) for e in (64, 32)
                                         for s in (1, 49, 65, 200)]
                         + [(3, 256, 4, 64)])
def test_flash_float32(dev, no_tf32, b, s, heads, e):
    """The float32 forms of K13 and K14 on strided float32 q, k, v: out,
    the logsumexp and the gradients against the plain versions, the last
    tile ragged; each launch counted on its own counter; a rerun bit-equal
    (no atomics). With one key dv is dout."""
    g = torch.Generator().manual_seed(24)
    qkv = torch.randn((b, s, 3, heads, e), generator=g) * (64 / e) ** 0.5
    q, k, v = qkv.to(dev).unbind(2)
    dout = torch.randn((b, s, heads, e), generator=g).to(dev)
    assert not q.is_contiguous()
    out, lse = counted(flash, lambda: flash.flash_forward(
        q, k, v, 0.125, save_lse=True), "launches_f32")
    grads = counted(flash, lambda: flash.flash_backward(
        q, k, v, out, lse, dout, 0.125), "bwd_launches_f32")
    torch.cuda.synchronize()
    for got, want in ((out, flash.reference(q, k, v, 0.125)),
                      (lse, flash.reference_lse(q, k, v, 0.125))):
        err = (got - want).abs().max().item()
        assert err <= F32_REL_BOUND * want.abs().max().item(), err
    wants = flash.reference_backward(q, k, v, dout, 0.125)
    for got, want in zip(grads, wants):
        assert got.dtype == torch.float32 and got.shape == want.shape
    if s == 1:
        err = (grads[2] - dout).abs().max().item()
        assert err <= F32_REL_BOUND * dout.abs().max().item(), err
    else:
        for got, want in zip(grads, wants):
            err = (got - want).abs().max().item()
            assert err <= F32_REL_BOUND * want.abs().max().item(), err
    again = flash.flash_backward(q, k, v, out, lse, dout, 0.125)
    for a, b_ in zip(grads, again):
        assert torch.equal(a, b_)


def f32_close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= F32_REL_BOUND * want.abs().max().item(), err


def f32(gen, dev, *shape, std=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * std + shift).to(dev)


@pytest.mark.parametrize("b,h,w,d,heads", [(2, 7, 7, 128, 2), (1, 9, 8, 192, 3),
                                           (3, 4, 4, 64, 2)])
def test_fused_qkv_float32(dev, no_tf32, b, h, w, d, heads):
    """K1's and K6's float32 forms against the plain versions on a ragged
    row tile (49 and 72 tokens), at head dims 64 and 32; each launch on its
    own counter; the backward rerun bit-equal."""
    g = torch.Generator().manual_seed(25)
    args = (f32(g, dev, b, h, w, d), rope.make_axial_pos(h, w, device=dev),
            f32(g, dev, b, d, std=0.1, shift=1.0),
            f32(g, dev, d, 3 * d, std=d ** -0.5),
            10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev), heads)
    cots = tuple(f32(g, dev, b, h, w, d) for _ in range(3))
    got = counted(fused_qkv, lambda: fused_qkv.prologue_forward(*args),
                  "launches_f32")
    for a, want in zip(got, fused_qkv.reference(*args)):
        f32_close(a, want)
    for a, b_ in zip(got, fused_qkv.prologue_forward(*args)):
        assert torch.equal(a, b_)
    grads = counted(fused_qkv, lambda: fused_qkv.prologue_backward(
        *args, *cots), "bwd_launches_f32")
    for a, want in zip(grads, fused_qkv.reference_backward(*args, *cots)):
        f32_close(a, want)
    for a, b_ in zip(grads, fused_qkv.prologue_backward(*args, *cots)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,t,d,d_ff", [(2, 49, 128, 384), (1, 72, 640, 1280),
                                        (3, 16, 64, 192), (2, 49, 256, 768),
                                        (1, 100, 512, 1536), (1, 16, 960, 1920),
                                        (2, 49, 768, 2304)])
def test_fused_ffn_float32(dev, no_tf32, b, t, d, d_ff):
    """K4's and K10's float32 forms against the plain versions, ragged row
    tiles, at d = 640, 768 and 960, wider than K10's bf16 form takes (K4 on
    its wide route: 64- and 128-column items), and at d = 64, 256 and 512
    (K4 in one launch: the x tile resident, or streamed with the column
    slabs paired); the forward and the backward reruns bit-equal."""
    g = torch.Generator().manual_seed(26)
    args = (f32(g, dev, b, t, d), f32(g, dev, b, d, std=0.1, shift=1.0),
            f32(g, dev, d, 2 * d_ff, std=d ** -0.5),
            f32(g, dev, d_ff, d, std=d_ff ** -0.5))
    cot = f32(g, dev, b, t, d)
    out = counted(fused_ffn, lambda: fused_ffn.ffn_forward(*args),
                  "launches_f32")
    f32_close(out, fused_ffn.reference(*args))
    assert torch.equal(out, fused_ffn.ffn_forward(*args))
    grads = counted(fused_ffn, lambda: fused_ffn.ffn_backward(*args, cot),
                    "bwd_launches_f32")
    for a, want in zip(grads, fused_ffn.reference_backward(*args, cot)):
        f32_close(a, want)
    for a, b_ in zip(grads, fused_ffn.ffn_backward(*args, cot)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,d,d_ff,n", [(3, 256, 768, 2), (70, 768, 2048, 2),
                                        (1, 64, 192, 1), (8, 256, 768, 2),
                                        (20, 256, 768, 3), (130, 256, 768, 2),
                                        (9, 1024, 4096, 8)])
def test_fused_mapping_float32(dev, no_tf32, b, d, d_ff, n):
    """K5's float32 form against the plain version at the HDiT's and the
    ViT's widths (strips of 8, 32 and 64 rows, the last ragged), one row, a
    batch past one strip of 64 and the deepest network at d 1024; one
    counted launch a call, a rerun bit-equal."""
    g = torch.Generator().manual_seed(27)
    blocks = [(f32(g, dev, d, std=0.1, shift=1.0),
               f32(g, dev, d, 2 * d_ff, std=d ** -0.5),
               f32(g, dev, d_ff, d, std=d_ff ** -0.5)) for _ in range(n)]
    args = (f32(g, dev, b, d), f32(g, dev, d, std=0.1, shift=1.0),
            f32(g, dev, d, std=0.1, shift=1.0), blocks)
    got = counted(fused_mapping, lambda: fused_mapping.mapping_forward(
        *args, dtype=torch.float32), "launches_f32")
    f32_close(got, fused_mapping.reference(*args, dtype=torch.float32))
    assert torch.equal(got, fused_mapping.mapping_forward(
        *args, dtype=torch.float32))


@pytest.mark.parametrize("b,s,heads", [(2, 64, 2), (1, 256, 8), (3, 48, 1)])
def test_global_packed_float32(dev, no_tf32, b, s, heads):
    """K3's and K9's float32 forms (attn_tf32.cuh on the packed layout)
    against the plain versions, out, the logsumexp and the gradients; each
    launch on its own counter."""
    g = torch.Generator().manual_seed(28)
    q, k, v, dout = (f32(g, dev, b, s, 64 * heads, std=0.3) for _ in range(4))
    out, lse = counted(global_packed, lambda: global_packed.packed_forward(
        q, k, v, heads, save_lse=True), "launches_f32")
    f32_close(out, global_packed.reference(q, k, v, heads))
    f32_close(lse, global_packed.reference_lse(q, k, v, heads))
    grads = counted(global_packed, lambda: global_packed.packed_backward(
        q, k, v, out, lse, dout, heads), "bwd_launches_f32")
    for a, want in zip(grads, global_packed.reference_backward(
            q, k, v, dout, heads)):
        f32_close(a, want)


def test_weight_gradients_are_deterministic(dev):
    """A rerun of K6 and K10 gives bit-equal gradients: every reduction over
    rows is a fixed-order sum of per-block partials."""
    g = torch.Generator().manual_seed(9)
    args = qkv_args(g, dev, 4, 32, 32, 128)
    cots = [normal(g, dev, 4, 32, 32, 128) for _ in range(3)]
    first = fused_qkv.prologue_backward(*args, *cots)
    again = fused_qkv.prologue_backward(*args, *cots)
    args = ffn_args(g, dev, 4, 1024, 128, 384)
    cot = normal(g, dev, 4, 1024, 128)
    first += fused_ffn.ffn_backward(*args, cot)
    again += fused_ffn.ffn_backward(*args, cot)
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,h,d", [(3, 8, 128), (2, 16, 256), (8, 4, 512)])
def test_strided_scale_rows(dev, b, h, d):
    """K1 and K4 read a (b, d) block of a wider condcache row through its
    row stride: bit-equal to the block's contiguous copy, with no copy
    made; a misaligned block and a strided block under autograd raise
    before any launch."""
    g = torch.Generator().manual_seed(17)
    row = (1 + 0.1 * torch.randn((b, 7 * d), generator=g)).to(dev, torch.bfloat16)
    block = row[:, 3 * d:4 * d]
    x, pos, _, w_qkv, a_scale, heads = qkv_args(g, dev, b, h, h, d)
    xt, _, w_up, w_down = ffn_args(g, dev, b, h * h, d, 3 * d)
    with torch.no_grad():
        got = counted(fused_qkv, lambda: fused_qkv.fused_qkv_prologue(
            x, pos, block, w_qkv, a_scale, heads))
        want = fused_qkv.fused_qkv_prologue(x, pos, block.contiguous(), w_qkv,
                                            a_scale, heads)
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_)
        got = counted(fused_ffn, lambda: fused_ffn.fused_geglu_ffn(
            xt, block, w_up, w_down))
        assert torch.equal(got, fused_ffn.fused_geglu_ffn(
            xt, block.contiguous(), w_up, w_down))
        assert_close(got, fused_ffn.reference(xt, block, w_up, w_down))
        before = fused_ffn.launches
        with pytest.raises(ValueError, match="16-byte"):
            fused_ffn.fused_geglu_ffn(xt, row[:, 1:d + 1], w_up, w_down)
        assert fused_ffn.launches == before
    with pytest.raises(ValueError, match="forward-only"):
        fused_qkv.fused_qkv_prologue(x, pos, block, w_qkv, a_scale, heads)


def test_forwards_are_deterministic(dev):
    """A rerun of K1 and K4 gives bit-equal outputs: K4's hidden-panel
    partials meet in a fixed order, with no atomics."""
    g = torch.Generator().manual_seed(16)
    args = qkv_args(g, dev, 4, 32, 32, 256)
    first = fused_qkv.prologue_forward(*args)
    again = fused_qkv.prologue_forward(*args)
    for shape in ((4, 1024, 128, 384), (2, 256, 512, 1536)):
        args = ffn_args(g, dev, *shape)
        first += (fused_ffn.ffn_forward(*args),)
        again += (fused_ffn.ffn_forward(*args),)
    blocks = [(torch.ones(256, device=dev), *ffn_args(g, dev, 1, 1, 256, 768)[2:])
              for _ in range(2)]
    emb = normal(g, dev, 40, 256)
    first += (fused_mapping.mapping_forward(emb, blocks[0][0], blocks[1][0],
                                            blocks),)
    again += (fused_mapping.mapping_forward(emb, blocks[0][0], blocks[1][0],
                                            blocks),)
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


def test_autograd_runs_the_backward_kernels(dev):
    """Gradients through each differentiable wrapper come from its backward
    kernel (the mapping network: from its recomputed plain version; the
    fused-epilogue NA: from K2's recompute and K7), and equal the kernel
    entry points' own; no model path launches K8."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(10)
    x, pos, ns, w_qkv, scale, heads = qkv_args(g, dev, 2, 8, 8, 128)
    leaves = [t.requires_grad_() for t in (x, ns, w_qkv, scale)]
    q, k, v = fused_qkv.fused_qkv_prologue(x, pos, ns, w_qkv, scale, heads)
    out = na2d.na2d_packed(q, k, v, heads, 7)
    out = global_packed.packed_global_attention(
        out.reshape(2, 64, 128), k.reshape(2, 64, 128), v.reshape(2, 64, 128),
        heads)
    out = fused_ffn.fused_geglu_ffn(out, ns, *ffn_args(g, dev, 2, 64, 128, 384)[2:])
    out = flash.flash_attention(*(t.reshape(2, 64, 2, 64) for t in (out, k, v)),
                                0.125)
    blocks = [(torch.ones(128, device=dev, requires_grad=True),
               torch.randn((128, 384), generator=g).to(dev) * 128 ** -0.5,
               torch.randn((192, 128), generator=g).to(dev) * 192 ** -0.5)]
    emb = fused_mapping.fused_mapping(ns, torch.ones(128, device=dev),
                                      torch.ones(128, device=dev), blocks)
    heads = na2d.na2d(*(t.reshape(2, 8, 8, 2, 64) for t in (q, k, v)), 7)
    w_out = torch.randn((128, 128), generator=g).to(dev).requires_grad_()
    proj = na2d.na2d_packed_proj(q, k, v, x, w_out, 2, 7)
    (out.float().square().mean() + emb.float().square().mean()
     + heads.float().square().mean() + proj.float().square().mean()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert blocks[0][0].grad is not None and w_out.grad is not None
    assert x.grad.dtype == torch.bfloat16 and w_qkv.grad.dtype == torch.float32
    counts = kernels.launch_counts()
    # K15's backward recomputes with K2 and runs K7
    assert counts == dict.fromkeys(kernels.COUNTERS, 1) | {
        "na2d": 2, "na2d_bwd": 2, "na2d_overlap_add": 0} | {
        name: 0 for name in kernels.COUNTERS if name.endswith("_f32")}, counts


def test_wrappers_raise_instead_of_falling_back(dev):
    kernels.reset_launch_counts()
    x = torch.zeros((1, 12, 12, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        na2d.na2d_packed(x, x, x, 2, 7)
    # float16 (no kernel takes it) and mixed dtypes (float32 q, k and a
    # bfloat16 v)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.na2d_packed(*(torch.zeros((1, 8, 8, 128), device=dev,
                                       dtype=torch.float16),) * 3, 2, 7)
    f = torch.zeros((1, 8, 8, 128), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        na2d.na2d_packed(f, f, f.bfloat16(), 2, 7)
    # K7: a map that does not tile, a float32 cotangent, an lse of the
    # wrong shape, a CPU tensor
    x = torch.zeros((1, 8, 8, 128), device=dev, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8, 8), device=dev)
    y = torch.zeros((1, 12, 12, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        na2d.packed_backward(y, y, y, y, lse, y, 2, 7)
    with pytest.raises(ValueError, match="dout has dtype"):
        na2d.packed_backward(x, x, x, x, lse, x.float(), 2, 7)
    with pytest.raises(ValueError, match="lse has shape"):
        na2d.packed_backward(x, x, x, x, lse[:, :1], x, 2, 7)
    with pytest.raises(ValueError, match="no kernel for device"):
        na2d.packed_backward(*(t.cpu() for t in (x, x, x, x, lse, x)), 2, 7)
    s = torch.zeros((1, 528, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 512"):
        global_packed.packed_global_attention(s, s, s, 1)
    # 2 heads of 48; 3 heads of 32 (d = 96 is not a multiple of 64)
    for heads in (2, 3):
        x = torch.zeros((1, 8, 8, 96), device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim 32 or 64"):
            fused_qkv.fused_qkv_prologue(
                x, rope.make_axial_pos(8, 8, device=dev),
                torch.ones((1, 96), device=dev, dtype=torch.bfloat16),
                torch.zeros((96, 288), device=dev),
                torch.ones(heads, device=dev), heads)
    # K1 and K4 wider than their shared memory holds
    x = torch.zeros((1, 8, 8, 832), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d up to"):
        fused_qkv.fused_qkv_prologue(
            x, rope.make_axial_pos(8, 8, device=dev),
            torch.ones((1, 832), device=dev, dtype=torch.bfloat16),
            torch.zeros((832, 3 * 832), device=dev), torch.ones(13, device=dev), 13)
    x = torch.zeros((1, 64, 960), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d up to"):
        fused_ffn.fused_geglu_ffn(x, torch.ones((1, 960), device=dev),
                                  torch.zeros((960, 128), device=dev),
                                  torch.zeros((64, 960), device=dev))
    # K10 wider than its first kernel's shared memory holds
    x = torch.zeros((1, 64, 640), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d up to 576"):
        fused_ffn.ffn_backward(x, torch.ones((1, 640), device=dev,
                                             dtype=torch.bfloat16),
                               torch.zeros((640, 128), device=dev),
                               torch.zeros((64, 640), device=dev), x)
    # K5: deeper than its layer table, float16 weights
    e = torch.zeros((2, 128), device=dev, dtype=torch.bfloat16)
    one = torch.ones(128, device=dev)
    block = (one, torch.zeros((128, 128), device=dev),
             torch.zeros((64, 128), device=dev))
    with pytest.raises(ValueError, match="1 to 8 blocks"):
        fused_mapping.fused_mapping(e, one, one, [block] * 9)
    with pytest.raises(ValueError, match="float32 or bfloat16 weights"):
        fused_mapping.fused_mapping(e, one, one,
                                    [tuple(t.half() for t in block)])
    x = torch.zeros((1, 16, 2, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        flash.flash_attention(x, x, x)
    # K11/K12: head dim 48, a map that does not tile, float16, mixed dtypes
    # at head dim 128, heads not packed
    for shape in ((1, 8, 8, 2, 48), (1, 12, 8, 2, 64)):
        x = torch.zeros(shape, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim in"):
            na2d.na2d(x, x, x, 7)
    x = torch.zeros((1, 8, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.na2d(x, x, x, 7)
    x = torch.zeros((1, 8, 8, 1, 128), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        na2d.na2d(x, x.bfloat16(), x, 7)
    x = torch.zeros((1, 8, 8, 64, 2), device=dev,
                    dtype=torch.bfloat16).transpose(3, 4)
    with pytest.raises(ValueError, match="strides"):
        na2d.na2d(x, x, x, 7)
    # K15: c not a multiple of 128, c above 512; head dim 128 (a softmax is
    # not split over the cluster's ranks of 64 channels)
    for heads in (3, 10):
        x = torch.zeros((1, 8, 8, 64 * heads), device=dev, dtype=torch.bfloat16)
        w = torch.zeros((64 * heads,) * 2, device=dev)
        with pytest.raises(ValueError, match="c <= 512"):
            na2d.na2d_packed_proj(x, x, x, x, w, heads, 7)
    x = torch.zeros((1, 8, 8, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        na2d.na2d_packed_proj(x, x, x, x, torch.zeros((256, 256), device=dev),
                              2, 7)
    # K13/K14: float16, and q, k, v of mixed dtypes (bfloat16 and float32
    # each have kernels)
    x = torch.zeros((1, 16, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="takes q's torch.float32"):
        flash.flash_attention(x.float(), x.bfloat16(), x.float())
    # the head axis not packed at the head dim; q's strides unlike k's
    x = torch.zeros((1, 2, 16, 64), device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        flash.flash_attention(x, x, x)
    y = x.contiguous()
    with pytest.raises(ValueError, match="strides"):
        flash.flash_attention(y, x, y)
    assert kernels.launch_counts() == dict.fromkeys(kernels.COUNTERS, 0)


# ---- head dim 32 (configs/config_test_tiny.json: 2 heads of 32) -----------

@pytest.mark.parametrize("b,h,w,d", [(3, 8, 8, 64), (2, 4, 4, 128)])
def test_fused_qkv_head_dim_32(dev, b, h, w, d):
    """K1 and K6 at head dim 32 (two heads per 64-column panel); 4 x 4
    maps leave a 64-row tile ragged."""
    g = torch.Generator().manual_seed(15)
    heads = d // 32
    args = (normal(g, dev, b, h, w, d), rope.make_axial_pos(h, w, device=dev),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, torch.bfloat16),
            torch.randn((d, 3 * d), generator=g).to(dev) * d ** -0.5,
            10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev), heads)
    got = counted(fused_qkv, lambda: fused_qkv.fused_qkv_prologue(*args))
    assert_all_close(got, fused_qkv.reference(*args))
    cots = [normal(g, dev, b, h, w, d) for _ in range(3)]
    got = counted(fused_qkv, lambda: fused_qkv.prologue_backward(*args, *cots),
                  "bwd_launches")
    assert_all_close(got, fused_qkv.reference_backward(*args, *cots))


@pytest.mark.parametrize("b,s,heads,scale", [(8, 64, 2, 1.0), (2, 100, 3, 0.125),
                                             (1, 200, 2, 0.125), (2, 1, 1, 0.125)])
def test_flash_head_dim_32(dev, b, s, heads, scale):
    """K13 and K14 at head dim 32 on strided q, k, v; bit-equal reruns."""
    g = torch.Generator().manual_seed(16)
    q, k, v, dout = flash_qkv(g, dev, b, s, heads, scale, e=32)
    got = counted(flash, lambda: flash.flash_attention(q, k, v, scale))
    assert_close(got, flash.reference(q, k, v, scale))
    if s == 1:
        return
    out, lse = flash.flash_forward(q, k, v, scale, save_lse=True)
    got = counted(flash, lambda: flash.flash_backward(q, k, v, out, lse, dout,
                                                      scale), "bwd_launches")
    assert_all_close(got, flash.reference_backward(q, k, v, dout, scale))
    again = flash.flash_backward(q, k, v, out, lse, dout, scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


# ---- K11/K12: per-head NA; K15: packed NA with the fused epilogue ---------

# (b, h, w, heads, e, ks): map edges (h != w), one 8 x 8 tile, 12 heads,
# every head dim, smaller windows
HEADS_CASES = [(2, 16, 24, 2, 64, 7), (1, 8, 8, 12, 64, 7),
               (2, 32, 16, 4, 32, 7), (1, 16, 16, 2, 32, 3),
               (1, 24, 16, 1, 128, 5), (1, 16, 16, 2, 128, 7)]
# K12's edge tiles at every head dim: windows smaller than 7 on maps of 8
# and 16, where the slabs of queries reaching a key tile are cut by the
# map's edge
HEADS_EDGE_CASES = [(1, h, w, 2, e, ks) for e in (32, 64, 128)
                    for h, w in ((8, 8), (16, 16), (8, 16)) for ks in (1, 3, 5)]


def heads_qkv(g, dev, b, h, w, heads, e):
    """q, k cosine-sim and contiguous, v a strided third of one (b, h, w,
    3, heads, e) projection (as the unfused prologue leaves them), and a
    cotangent."""
    t = torch.randn((b, h, w, 3, heads, e), generator=g)
    qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True) * 10 ** 0.5
    proj = torch.cat([qk, t[:, :, :, 2:]], 3).to(dev, torch.bfloat16)
    q, k, v = proj.unbind(3)
    return (q.contiguous(), k.contiguous(), v,
            normal(g, dev, b, h, w, heads, e))


# the forward also at every odd kernel size on one tile, h != w and a map
# with interior tiles, at every head dim
HEADS_FWD_CASES = HEADS_CASES + [
    (1, h, w, 2, e, ks) for e in (32, 64, 128)
    for h, w in ((8, 8), (16, 24), (32, 32)) for ks in (1, 3, 5, 7)]


@pytest.mark.parametrize("b,h,w,heads,e,ks", HEADS_FWD_CASES)
def test_na2d_heads(dev, b, h, w, heads, e, ks):
    """K11 against the plain version, its logsumexp against the f32 masked
    logits."""
    g = torch.Generator().manual_seed(17)
    q, k, v, _ = heads_qkv(g, dev, b, h, w, heads, e)
    assert not v.is_contiguous()
    got = counted(na2d, lambda: na2d.na2d(q, k, v, ks), "heads_launches")
    assert_close(got, na2d.na2d_reference(q, k, v, ks))
    out, lse = na2d.heads_forward(q, k, v, ks, save_lse=True)
    assert torch.equal(out, got)
    assert_close(lse, na_logsumexp(q, k, ks))


@pytest.mark.parametrize("b,h,w,heads,e,ks", HEADS_CASES)
def test_na2d_heads_backward(dev, b, h, w, heads, e, ks):
    """K12 (the dq kernel and the key-tile dk/dv kernel) against autograd
    through the plain version; a rerun gives bit-equal gradients (no
    partials, no atomics)."""
    g = torch.Generator().manual_seed(18)
    q, k, v, dout = heads_qkv(g, dev, b, h, w, heads, e)
    out, lse = na2d.heads_forward(q, k, v, ks, save_lse=True)
    got = counted(na2d, lambda: na2d.heads_backward(q, k, v, out, lse, dout, ks),
                  "heads_bwd_launches")
    assert_all_close(got, na2d.heads_reference_backward(q, k, v, dout, ks))
    again = na2d.heads_backward(q, k, v, out, lse, dout, ks)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("b,h,w,heads,e,ks", HEADS_EDGE_CASES)
def test_na2d_heads_backward_edges(dev, b, h, w, heads, e, ks):
    """K12 at small windows and maps of 8 and 16 (v strided): dq, dk, dv
    against autograd through the plain version. At ks = 1 the plain dq and
    dk are exactly 0 (a window of one key: the softmax has no gradient in
    its logit) and the kernel's hold only the f32 rounding of dP - delta:
    they are held to the bound on the scale of dv."""
    g = torch.Generator().manual_seed(27)
    q, k, v, dout = heads_qkv(g, dev, b, h, w, heads, e)
    out, lse = na2d.heads_forward(q, k, v, ks, save_lse=True)
    got = counted(na2d, lambda: na2d.heads_backward(q, k, v, out, lse, dout, ks),
                  "heads_bwd_launches")
    want = na2d.heads_reference_backward(q, k, v, dout, ks)
    if ks == 1:
        assert not any(b_.any() for b_ in want[:2])
        scale = want[2].float().abs().max().item()
        assert all(a.float().abs().max().item() <= REL_BOUND * scale
                   for a in got[:2])
        assert_close(got[2], want[2])
    else:
        assert_all_close(got, want)


@pytest.mark.parametrize("b,h,w,heads,ks", [(8, 32, 32, 4, 7), (2, 16, 24, 2, 7),
                                            (1, 40, 24, 1, 3), (1, 8, 8, 2, 1)])
def test_na2d_packed_and_heads_backward_agree_bit_for_bit(dev, b, h, w, heads, ks):
    """K7 and K12 run one backward (csrc/na_bwd.cuh): on one packed input at
    head dim 64, read by K12 as its (b, h, w, heads, 64) views, k and v
    through their own strides, they give the same dq, dk, dv bit for bit."""
    g = torch.Generator().manual_seed(28)
    c = heads * 64
    q, k = unit_heads(g, dev, b, h, w, c), unit_heads(g, dev, b, h, w, c)
    v, dout = normal(g, dev, b, h, w, c), normal(g, dev, b, h, w, c)
    out, lse = na2d.packed_forward(q, k, v, heads, ks, save_lse=True)
    packed = na2d.packed_backward(q, k, v, out, lse, dout, heads, ks)
    split = [t.reshape(b, h, w, heads, 64) for t in (q, k, v, out, dout)]
    heads_grads = na2d.heads_backward(*split[:4], lse, split[4], ks)
    for a, b_ in zip(packed, heads_grads):
        assert torch.equal(a, b_.reshape(a.shape))


def proj_inputs(g, dev, b, h, w, heads, e):
    """K15's q, k (cosine-sim per head), v, skip and cotangent, bf16, and
    w_out (c, c) float32."""
    c = heads * e
    q, k = (unit_heads(g, dev, b, h, w, c, e=e) for _ in range(2))
    v, skip, dout = (normal(g, dev, b, h, w, c) for _ in range(3))
    w_out = torch.randn((c, c), generator=g).to(dev) * c ** -0.5
    return q, k, v, skip, w_out, dout


# (b, h, w, heads, e, ks): c = 128, 256, 384 and 512 at head dim 64, c =
# 128 and 512 at head dim 32 (two heads a rank), smaller windows, h != w
PROJ_CASES = [(2, 16, 24, 2, 64, 7), (1, 8, 8, 8, 64, 7), (1, 16, 16, 4, 64, 5),
              (1, 16, 16, 6, 64, 7), (2, 16, 24, 4, 32, 7), (1, 16, 16, 16, 32, 7),
              (1, 8, 16, 4, 32, 3)]


@pytest.mark.parametrize("b,h,w,heads,e,ks", PROJ_CASES)
def test_na2d_packed_proj(dev, b, h, w, heads, e, ks):
    """K15 against its plain version, and its gradients (the attention
    recomputed: K2 and K7 at head dim 64, K11 and K12 at 32; matmuls)
    against autograd through the plain version."""
    g = torch.Generator().manual_seed(19)
    q, k, v, skip, w_out, dout = proj_inputs(g, dev, b, h, w, heads, e)
    got = counted(na2d, lambda: na2d.na2d_packed_proj(q, k, v, skip, w_out,
                                                      heads, ks), "proj_launches")
    assert_close(got, na2d.proj_reference(q, k, v, skip, w_out, heads, ks))
    leaves = [t.detach().requires_grad_() for t in (q, k, v, skip, w_out)]
    grads = torch.autograd.grad(na2d.na2d_packed_proj(*leaves, heads, ks),
                                leaves, dout)
    with torch.enable_grad():
        plain = [t.detach().requires_grad_() for t in (q, k, v, skip, w_out)]
        want = torch.autograd.grad(na2d.proj_reference(*plain, heads, ks),
                                   plain, dout)
    assert_all_close(grads, want)


@pytest.mark.parametrize("b,h,w,heads,ks", [(2, 16, 24, 2, 7), (1, 8, 8, 8, 7),
                                            (1, 16, 16, 4, 3)])
def test_na2d_packed_proj_identity_is_k2(dev, b, h, w, heads, ks):
    """K15 with w_out = I and skip = 0 gives K2's output bit for bit: the
    attention is K2's (attn_fwd.cuh), rounded to bf16 at the same point,
    and the product with I and the add of 0 are exact."""
    g = torch.Generator().manual_seed(29)
    q, k, v, skip, _, _ = proj_inputs(g, dev, b, h, w, heads, 64)
    eye = torch.eye(heads * 64, device=dev)
    got = na2d.proj_forward(q, k, v, torch.zeros_like(skip), eye, heads, ks)
    want, _ = na2d.packed_forward(q, k, v, heads, ks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("heads,e", [(2, 64), (8, 64), (4, 32), (16, 32)])
def test_na2d_packed_proj_rerun_is_bit_equal(dev, heads, e):
    """K15 has no partials and no atomics: a rerun gives the same output
    bit for bit, at every cluster size it takes (2 to 8 ranks)."""
    g = torch.Generator().manual_seed(30)
    q, k, v, skip, w_out, _ = proj_inputs(g, dev, 2, 16, 24, heads, e)
    first = na2d.proj_forward(q, k, v, skip, w_out, heads, 7)
    assert torch.equal(na2d.proj_forward(q, k, v, skip, w_out, heads, 7),
                       first)


# K2, K7, K11 and K12 in float32 (csrc/na_tf32.cuh: attn_tf32.cuh's TF32
# bodies over the neighborhood geometry): (b, h, w, heads, e, ks), one tile
# and interior tiles, h != w, every window size class, head dims 64, 32
# and 128 (blocks of two warpgroups)
NA_F32_CASES = [(2, 16, 24, 2, 64, 7), (1, 32, 32, 2, 64, 7),
                (1, 8, 8, 2, 64, 1), (1, 16, 16, 1, 64, 3),
                (2, 32, 16, 4, 32, 7), (1, 8, 16, 2, 32, 5),
                (2, 16, 24, 2, 128, 7), (1, 32, 32, 1, 128, 5),
                (1, 8, 8, 1, 128, 1)]


def na_f32_inputs(g, dev, b, h, w, heads, e):
    """Float32 q, k (cosine-sim per head, contiguous), v a strided third of
    one (b, h, w, 3, heads, e) projection, and a cotangent."""
    t = torch.randn((b, h, w, 3, heads, e), generator=g)
    qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True) * 10 ** 0.5
    q, k, v = torch.cat([qk, t[:, :, :, 2:]], 3).to(dev).unbind(3)
    return (q.contiguous(), k.contiguous(), v,
            torch.randn((b, h, w, heads, e), generator=g).to(dev))


@pytest.mark.parametrize("b,h,w,heads,e,ks", NA_F32_CASES)
def test_na2d_float32(dev, no_tf32, b, h, w, heads, e, ks):
    """K11's and K12's float32 forms on strided float32 maps against the
    plain versions (TF32 off): out, the logsumexp, dq, dk, dv; each launch
    on its own counter; a rerun bit-equal (no atomics). At head dim 64 K2
    and K7 on the packed maps give the same out, lse, dq, dk, dv bit for
    bit: one kernel."""
    g = torch.Generator().manual_seed(31)
    q, k, v, dout = na_f32_inputs(g, dev, b, h, w, heads, e)
    assert not v.is_contiguous()
    out, lse = counted(na2d, lambda: na2d.heads_forward(
        q, k, v, ks, save_lse=True), "heads_launches_f32")
    f32_close(out, na2d.na2d_reference(q, k, v, ks))
    f32_close(lse, na_logsumexp(q, k, ks))
    grads = counted(na2d, lambda: na2d.heads_backward(
        q, k, v, out, lse, dout, ks), "heads_bwd_launches_f32")
    want = na2d.heads_reference_backward(q, k, v, dout, ks)
    if ks == 1:  # dq and dk are exactly 0 in the plain version (see above)
        scale = want[2].abs().max().item()
        assert all(a.abs().max().item() <= F32_REL_BOUND * scale
                   for a in grads[:2])
        f32_close(grads[2], want[2])
    else:
        for a, b_ in zip(grads, want):
            f32_close(a, b_)
    again = na2d.heads_backward(q, k, v, out, lse, dout, ks)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    if e != 64:
        return
    packed = [t.reshape(b, h, w, heads * e).contiguous()
              for t in (q, k, v, dout)]
    p_out, p_lse = counted(na2d, lambda: na2d.packed_forward(
        *packed[:3], heads, ks, save_lse=True), "launches_f32")
    assert torch.equal(p_out.reshape(out.shape), out)
    assert torch.equal(p_lse, lse)
    p_grads = counted(na2d, lambda: na2d.packed_backward(
        *packed[:3], p_out, p_lse, packed[3], heads, ks), "bwd_launches_f32")
    for a, b_ in zip(p_grads, grads):
        assert torch.equal(a.reshape(b_.shape), b_)


def test_na2d_float32_refusals(dev):
    """What the float32 forms do not take raises ValueError by name before
    any launch: float16 maps at head dim 128 (K11), float16 and mixed
    dtypes at K15, and K8 asked to write float16."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(32)
    q, k, v, _ = na_f32_inputs(g, dev, 1, 16, 16, 1, 128)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.heads_forward(q.half(), k.half(), v.half(), 7)
    x = torch.randn((1, 16, 16, 128), generator=g).to(dev)
    eye = torch.eye(128, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.na2d_packed_proj(*(x.half() for _ in range(4)), eye, 2, 7)
    with pytest.raises(ValueError, match="dtype"):
        na2d.na2d_packed_proj(x, x, x.bfloat16(), x, eye, 2, 7)
    part = torch.zeros((1, 2, 4, na2d.HALO_KEYS, 64), device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        na2d.overlap_add(part, part, 16, 16, 7, dtype=torch.float16)
    assert kernels.launch_counts() == dict.fromkeys(kernels.COUNTERS, 0)


# K15 in float32 (csrc/na_proj_tf32.cuh): (b, h, w, heads, e, ks), clusters
# of 2, 8 and 6 ranks at head dim 64, two heads a rank at head dim 32
PROJ_F32_CASES = [(2, 16, 24, 2, 64, 7), (1, 8, 8, 8, 64, 7),
                  (1, 16, 16, 6, 64, 5), (2, 16, 24, 4, 32, 7),
                  (1, 8, 16, 16, 32, 3)]


def proj_f32_inputs(g, dev, b, h, w, heads, e):
    """K15's operands in float32: q, k (cosine-sim per head), v, skip and
    the cotangent (b, h, w, heads * e), w_out (c, c)."""
    c = heads * e
    t = torch.randn((2, b, h, w, heads, e), generator=g)
    q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
        2, b, h, w, c).to(dev)
    v, skip, dout = (f32(g, dev, b, h, w, c) for _ in range(3))
    return q, k, v, skip, f32(g, dev, c, c, std=c ** -0.5), dout


@pytest.mark.parametrize("b,h,w,heads,e,ks", PROJ_F32_CASES)
def test_na2d_packed_proj_float32(dev, no_tf32, b, h, w, heads, e, ks):
    """K15's float32 form against its plain version (TF32 off), a rerun
    bit-equal, and its gradients (the attention recomputed by the float32
    forms of K2 and K7, or of K11 and K12 at head dim 32; matmuls) against
    autograd through the plain version. With w_out = I and skip = 0 it is
    the float32 forward's attention output (K2-f32 at head dim 64, K11-f32
    at 32) rounded once to TF32: within 2^-10 of it, element by element."""
    g = torch.Generator().manual_seed(33)
    q, k, v, skip, w_out, dout = proj_f32_inputs(g, dev, b, h, w, heads, e)
    got = counted(na2d, lambda: na2d.na2d_packed_proj(
        q, k, v, skip, w_out, heads, ks), "proj_launches_f32")
    f32_close(got, na2d.proj_reference(q, k, v, skip, w_out, heads, ks))
    assert torch.equal(na2d.proj_forward(q, k, v, skip, w_out, heads, ks), got)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, skip, w_out)]
    grads = torch.autograd.grad(na2d.na2d_packed_proj(*leaves, heads, ks),
                                leaves, dout)
    with torch.enable_grad():
        plain = [t.detach().requires_grad_() for t in (q, k, v, skip, w_out)]
        want = torch.autograd.grad(na2d.proj_reference(*plain, heads, ks),
                                   plain, dout)
    for a, b_ in zip(grads, want):
        f32_close(a, b_)
    eye = torch.eye(heads * e, device=dev)
    ident = na2d.proj_forward(q, k, v, torch.zeros_like(skip), eye, heads, ks)
    if e == 64:
        att, _ = na2d.packed_forward(q, k, v, heads, ks)
    else:
        att = na2d.heads_forward(*(t.reshape(b, h, w, heads, e)
                                   for t in (q, k, v)), ks)[0].reshape(q.shape)
    torch.cuda.synchronize()
    assert ((ident - att).abs() <= 2 ** -10 * att.abs()).all()


@pytest.mark.parametrize("b,h,w,heads,ks", [(2, 16, 24, 2, 7), (1, 24, 16, 1, 3)])
def test_na2d_overlap_add_float32(dev, b, h, w, heads, ks):
    """K8's float32 form against its plain overlap-add in float32 of the
    same plain per-tile halo partials (the same sums of at most 9 terms in
    another order: within 1e-5 x max|plain|), on its own counter."""
    g = torch.Generator().manual_seed(34)
    c = heads * 64
    t = torch.randn((2, b, h, w, heads, 64), generator=g)
    q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
        2, b, h, w, c).to(dev)
    v, dout = (f32(g, dev, b, h, w, c) for _ in range(2))
    dk_part, dv_part = na2d.packed_backward_partials_reference(q, k, v, dout,
                                                               heads, ks)
    got = counted(na2d, lambda: na2d.overlap_add(
        dk_part, dv_part, h, w, ks, dtype=torch.float32),
        "overlap_launches_f32")
    want = na2d.overlap_add_reference(dk_part, dv_part, h, w, ks,
                                      dtype=torch.float32)
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b_.shape
        err = (a - b_).abs().max().item()
        assert err <= 1e-5 * b_.abs().max().item(), err
