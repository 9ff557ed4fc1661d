"""The port's condcache (k_diffusion_tpu_torch.condcache) and the HDiT's
side of it against the JAX package on the CPU: the scale layout, the
precomputed table, the cached forward bit for bit against the uncached one
under every schedule-point sampler, the refusals the JAX package does not
make (an off-schedule sigma, conditioning beside the table, autograd), and
the kernel wrappers' strided scale rows."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu import condcache as jcc
from k_diffusion_tpu.models import image_transformer_v2 as jitv2
from k_diffusion_tpu_torch import condcache as tcc
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch.models import image_transformer_v2 as titv2
from k_diffusion_tpu_torch.ops.kernels import _build, fused_ffn, fused_qkv

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "config_test_tiny.json"
FLAGSHIP = REPO / "configs" / "config_oxford_flowers.json"
# the flagship with 1 layer per level and half the widths, d_head 64: NA on
# 16x16 and 8x8 tokens, global on 4x4 (tests/test_torch_model.py's cut)
NA_OVERRIDES = {"depths": [1, 1, 1], "widths": [64, 128, 256],
                "d_ffs": [192, 384, 768], "input_size": [64, 64],
                "dropout_rate": [0.0, 0.0, 0.0]}
# both tables in float32: the mapping network and one small product each
TABLE_TOL = 2e-6


def specs(module, kind, d_head, extra):
    return {"global": lambda: module.GlobalAttentionSpec(d_head),
            "neighborhood": lambda: module.NeighborhoodAttentionSpec(d_head,
                                                                     extra),
            "window": lambda: module.ShiftedWindowAttentionSpec(d_head, extra),
            "none": lambda: module.NoAttentionSpec()}[kind]()


LEVEL_LISTS = {
    "global": [(2, 32, 64, "global", 16, 0), (1, 64, 128, "global", 32, 0)],
    "neighborhood": [(2, 32, 64, "neighborhood", 16, 3),
                     (1, 64, 128, "global", 32, 0)],
    "window": [(2, 32, 64, "window", 16, 4), (1, 64, 128, "global", 32, 0)],
    "none": [(1, 32, 64, "none", 0, 0), (1, 64, 128, "global", 32, 0)],
    # the 512px config's shape: the width-768 mid level aligns 512 -> 768
    "aligned": [(2, 128, 256, "global", 64, 0),
                (1, 768, 2048, "global", 64, 0)],
    "flagship": [(2, 128, 384, "neighborhood", 64, 7),
                 (2, 256, 768, "neighborhood", 64, 7),
                 (4, 512, 1536, "global", 64, 0)],
}


@pytest.mark.parametrize("name", LEVEL_LISTS)
def test_cond_scale_layout_matches_jax(name):
    def levels(module):
        return tuple(module.LevelSpec(depth, width, d_ff,
                                      specs(module, kind, e, extra), 0.0)
                     for depth, width, d_ff, kind, e, extra in LEVEL_LISTS[name])

    got = titv2.cond_scale_layout(levels(titv2))
    want = jitv2.cond_scale_layout(levels(jitv2))
    assert got == want
    assert list(got[0]) == list(want[0])  # forward order
    if name == "flagship":
        assert len(got[0]) == 12 and got[1] == 7168


def randomized(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        if path[-1].key == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.float32(np.sqrt(p.shape[0]))
        return p * (1 + np.float32(0.1) * noise)

    return jax.tree_util.tree_map_with_path(fill, params)


def load(path, overrides=None):
    raw = json.loads(Path(path).read_text())
    raw["model"].update(overrides or {})
    return raw


@pytest.fixture(scope="module", params=["tiny", "na"])
def models(request):
    """(JAX model, randomized params, the port's model with them, batch
    classes or None): config_test_tiny (class-conditional, global) and the
    reduced flagship (NA levels)."""
    raw = (load(TINY) if request.param == "tiny"
           else load(FLAGSHIP, NA_OVERRIDES))
    jconfig = K.config.load_config(raw)
    model = K.config.make_model(jconfig)
    size = raw["model"]["input_size"]
    classes = np.int32([1, 3, 0]) if jconfig["dataset"]["num_classes"] else None
    init_kw = ({"class_cond": jnp.zeros((1,), jnp.int32)}
               if classes is not None else {})
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, *size, 3)), jnp.ones((1,)),
                                 **init_kw)["params"]
    params = randomized(params, 7)
    port = KT.config.make_model(KT.config.load_config(raw),
                                device="cpu").eval()
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model, params, port, classes, size


SIGMAS = np.array(K.sampling.get_sigmas_karras(5, 0.01, 80.0))


def test_table_matches_jax(models):
    model, params, port, classes, _ = models
    jkw = {} if classes is None else {"class_cond": jnp.asarray(classes)}
    tkw = {} if classes is None else {
        "class_cond": torch.from_numpy(classes).long()}
    jsig, jtable = jcc.precompute_cond_scales(
        model, {"params": params}, jnp.asarray(SIGMAS[:-1]), 3, **jkw)
    tsig, ttable = tcc.precompute_cond_scales(
        port, torch.from_numpy(SIGMAS[:-1]), 3, **tkw)
    np.testing.assert_array_equal(tsig.numpy(), np.asarray(jsig))
    jtable = np.asarray(jtable)
    assert ttable.shape == jtable.shape
    _, total = titv2.cond_scale_layout(port.levels)
    assert ttable.shape == (len(SIGMAS) - 1, 3, total)
    assert ttable.dtype == torch.float32
    assert np.abs(ttable.numpy() - jtable).max() <= TABLE_TOL * np.abs(jtable).max()


def test_cached_forward_is_the_uncached_forward(models):
    """model(x, sigma, cond_scales=row) equals model(x, sigma, class_cond)
    bit for bit at every schedule sigma."""
    _, _, port, classes, size = models
    tkw = {} if classes is None else {
        "class_cond": torch.from_numpy(classes).long()}
    _, table = tcc.precompute_cond_scales(
        port, torch.from_numpy(SIGMAS[:-1]), 3, **tkw)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, *size, 3)).astype(np.float32))
    with torch.no_grad():
        for i, s in enumerate(SIGMAS[:-1]):
            sigma = torch.full((3,), float(s))
            assert torch.equal(port(x, sigma, cond_scales=table[i]),
                               port(x, sigma, **tkw))
            # the cond_only forward is the table's source
            assert port(None, sigma, cond_only=True, **tkw).shape == (3, 256)


@pytest.mark.parametrize("sampler", sorted(tcc.SCHEDULE_POINT_SAMPLERS))
def test_cached_sampling_is_the_uncached_sampling(models, sampler):
    """Each schedule-point sampler, through the preconditioner: the cached
    model gives the uncached trajectory bit for bit, and its check
    passes."""
    _, _, port, classes, size = models
    tkw = {} if classes is None else {
        "class_cond": torch.from_numpy(classes).long()}
    x = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (3, *size, 3)) * 80).astype(np.float32))
    sigmas = torch.from_numpy(SIGMAS)
    cached = tcc.ScheduledModel(port, sigmas[:-1], 3, **tkw)
    got = KT.sampling.call_sampler(
        sampler, KT.Denoiser(cached, sigma_data=0.5), x, sigmas,
        generator=torch.Generator().manual_seed(1))
    cached.check()
    want = KT.sampling.call_sampler(
        sampler, KT.Denoiser(port, sigma_data=0.5), x, sigmas,
        extra_args=tkw, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, want)


def test_off_schedule_sigma_raises(models):
    """An off-schedule sigma runs (no host read in the call) and check()
    raises naming it; a sampler with midpoint stages (dpm_2) is caught the
    same way."""
    _, _, port, classes, size = models
    tkw = {} if classes is None else {
        "class_cond": torch.from_numpy(classes).long()}
    sigmas = torch.from_numpy(SIGMAS)
    cached = tcc.ScheduledModel(port, sigmas[:-1], 3, **tkw)
    x = torch.zeros((3, *size, 3))
    cached(x, torch.full((3,), float(SIGMAS[1])))
    cached.check()
    cached(x, torch.full((3,), 3.0))
    cached(x, torch.full((3,), 5.0))
    with pytest.raises(ValueError, match=r"sigma 3\.0 is not in the schedule"):
        cached.check()
    # the same sigma for the whole batch only
    mixed = tcc.ScheduledModel(port, sigmas[:-1], 3, **tkw)
    mixed(x, torch.tensor([float(SIGMAS[0])] * 2 + [float(SIGMAS[1])]))
    with pytest.raises(ValueError, match="not in the schedule"):
        mixed.check()
    midpoints = tcc.ScheduledModel(port, sigmas[:-1], 3, **tkw)
    KT.sampling.sample_dpm_2(KT.Denoiser(midpoints, sigma_data=0.5),
                             x + 80, sigmas)
    with pytest.raises(ValueError, match="not in the schedule"):
        midpoints.check()


def test_cond_scales_refuses_conditioning_and_autograd(models):
    """The JAX forward silently drops class_cond and aug_cond beside
    cond_scales, and its wide-scale path fails opaquely under
    differentiation; the port raises for both."""
    _, _, port, classes, size = models
    tkw = {} if classes is None else {
        "class_cond": torch.from_numpy(classes).long()}
    _, table = tcc.precompute_cond_scales(
        port, torch.from_numpy(SIGMAS[:-1]), 3, **tkw)
    x, sigma = torch.zeros((3, *size, 3)), torch.full((3,), float(SIGMAS[0]))
    with torch.no_grad():
        with pytest.raises(ValueError, match="conditioning"):
            port(x, sigma, cond_scales=table[0],
                 class_cond=torch.zeros(3, dtype=torch.long))
        with pytest.raises(ValueError, match="conditioning"):
            port(x, sigma, cond_scales=table[0], aug_cond=torch.zeros((3, 9)))
        with pytest.raises(ValueError, match="layout takes"):
            port(x, sigma, cond_scales=table[0][:, :-64])
    with pytest.raises(RuntimeError, match="forward-only"):
        port(x, sigma, cond_scales=table[0])


def test_scale_views_are_not_copies(models):
    """Each layer's scale is a (b, d) view of the row (same storage, row
    stride = the layout's total)."""
    _, _, port, classes, _ = models
    _, total = titv2.cond_scale_layout(port.levels)
    row = torch.ones((3, total))
    scales = port._layer_scales(row)
    for attn, ff in scales.values():
        for view in (attn, ff):
            assert view.data_ptr() - row.data_ptr() >= 0
            assert view.untyped_storage().data_ptr() == row.untyped_storage().data_ptr()
            assert view.stride() == (total, 1)


def test_strided_scale_plain_versions_and_checks():
    """K1's and K4's wrappers take a (b, d) block of a wider row: their
    plain versions give what they give on the block's copy; under autograd
    the block is refused (the backward kernels take a contiguous scale);
    the row check accepts aligned blocks and names what it refuses."""
    g = torch.Generator().manual_seed(3)
    b, h, w, d, heads = 2, 4, 4, 64, 2
    row = torch.randn((b, 5 * d), generator=g) * 0.1 + 1
    block = row[:, 2 * d:3 * d]
    x = torch.randn((b, h, w, d), generator=g)
    pos = KT.ops.rope.make_axial_pos(h, w)
    w_qkv = torch.randn((d, 3 * d), generator=g) / 8
    attn_scale = torch.full((heads,), 10.0)
    w_up = torch.randn((d, 2 * 3 * d), generator=g) / 8
    w_down = torch.randn((3 * d, d), generator=g) / 8
    with torch.no_grad():
        for a, c in zip(fused_qkv.fused_qkv_prologue(
                x, pos, block, w_qkv, attn_scale, heads),
                fused_qkv.fused_qkv_prologue(
                x, pos, block.clone(), w_qkv, attn_scale, heads)):
            assert torch.equal(a, c)
        xt = x.reshape(b, h * w, d)
        assert torch.equal(fused_ffn.fused_geglu_ffn(xt, block, w_up, w_down),
                           fused_ffn.fused_geglu_ffn(xt, block.clone(), w_up,
                                                     w_down))
    with pytest.raises(ValueError, match="forward-only"):
        fused_qkv.fused_qkv_prologue(x, pos, block, w_qkv, attn_scale, heads)
    with pytest.raises(ValueError, match="forward-only"):
        fused_ffn.fused_geglu_ffn(xt, block, w_up, w_down)
    wide = row.to(torch.bfloat16)
    assert _build.require_rows(wide[:, d:2 * d], "s", wide.device,
                               torch.bfloat16, (b, d)) == 5 * d
    assert _build.require_rows(wide[:, :d].contiguous(), "s", wide.device,
                               torch.bfloat16, (b, d)) == d
    with pytest.raises(ValueError, match="16-byte"):
        _build.require_rows(wide[:, 1:d + 1], "s", wide.device,
                            torch.bfloat16, (b, d))
    with pytest.raises(ValueError, match="16-byte"):
        _build.require_rows(wide[:, ::2][:, :d], "s", wide.device,
                            torch.bfloat16, (b, d))
    with pytest.raises(ValueError, match="shape"):
        _build.require_rows(wide, "s", wide.device, torch.bfloat16, (b, d))
