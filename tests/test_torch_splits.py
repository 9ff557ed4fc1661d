"""How the forward kernels K1 (fused_qkv) and K4 (fused_ffn) lay out their
grids: the shared-memory fit and the split cost model in ops/kernels/_build.py,
and each wrapper's choice at the flagship's batch-8 shapes. The occupancy
queries need a card, so the tests patch in the numbers the kernels' own
queries returned on an NVIDIA H100 80GB HBM3 (132 SMs)."""

import pytest
import torch

from k_diffusion_tpu_torch.ops.kernels import _build, fused_ffn, fused_qkv

SMS = 132
CARD = torch.device("cuda", 0)  # a device object only: nothing is allocated

# clusters of g blocks that fit on the card at once, per (warpgroups,
# out_tiles) of K4, from kdt_ffn_fwd's occupancy query on the H100
CLUSTERS = {(1, 2): {1: 264, 2: 132},
            (1, 4): {1: 264, 2: 132, 3: 79},
            (2, 8): {2: 66, 3: 39, 4: 30, 6: 17}}


def test_fits_is_one_blocks_shared_memory():
    # 28 tiles of 8 KB and the alignment slack fit in 227 KB, 29 do not
    assert _build.fits(28)
    assert not _build.fits(29)


def test_best_split_fills_the_card_in_as_few_rounds_as_it_can():
    work = lambda g: 24 / g / 2 * 12 + 12
    slots = lambda g: CLUSTERS[2, 8].get(g, 0) * g
    # 32 row tiles: 3 blocks each fit in one round (117 slots); 4 would not
    # (120 slots for 128 blocks) and take two
    assert _build.best_split(32, 8, slots, work) == (60.0, 3)


def test_best_split_takes_the_smaller_split_on_a_tie():
    assert _build.best_split(10, 4, lambda g: 100, lambda g: 6) == (6, 1)


def test_best_split_refuses_a_grid_that_never_fits():
    with pytest.raises(ValueError, match="fits"):
        _build.best_split(4, 2, lambda g: 0, lambda g: 1)


@pytest.mark.parametrize("tokens,d,d_ff,want", [
    (4096, 128, 384, (1, 2, 1)),   # level 0: one warpgroup, 512 blocks
    (1024, 256, 768, (1, 4, 2)),   # level 1: the hidden panels in 2
    (256, 512, 1536, (2, 8, 3)),   # level 2: two warpgroups, 8 tiles, 3
])
def test_ffn_forward_split_at_flagship_shapes(monkeypatch, tokens, d, d_ff,
                                              want):
    monkeypatch.setattr(fused_ffn, "_clusters",
                        lambda index, d, d_ff, wg, tiles, g:
                        CLUSTERS[wg, tiles].get(g, 0))
    assert fused_ffn.forward_split(8, tokens, d, d_ff, CARD) == want


@pytest.mark.parametrize("d,want", [(64, (1, 1)), (192, (1, 1)),
                                    (384, (2, 6)), (640, (2, 2)),
                                    (768, (2, 6))])
def test_ffn_forward_split_holds_every_width(monkeypatch, d, want):
    """Every d the wrapper takes gets a block layout whose output tiles
    divide d / 64."""
    monkeypatch.setattr(fused_ffn, "_clusters", lambda *args: 1)
    wg, tiles, groups = fused_ffn.forward_split(8, 256, d, 4 * d, CARD)
    assert (wg, tiles) == want and d // 64 % tiles == 0 and groups >= 1


@pytest.mark.parametrize("tokens,d,blocks_per_sm,want", [
    (4096, 128, 2, (2, 1)),   # level 0: 256 blocks of two row tiles
    (256, 512, 1, (2, 8)),    # level 2: 16 blocks, the units split in 8
    (256, 768, 1, (1, 8)),    # config_512_hdit: one panel a step fits
])
def test_qkv_forward_split_at_flagship_shapes(monkeypatch, tokens, d,
                                              blocks_per_sm, want):
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    monkeypatch.setattr(fused_qkv, "_blocks_per_sm",
                        lambda *args: blocks_per_sm)
    assert fused_qkv.forward_split(8, tokens, d, d // 64, CARD) == want
