"""Gradient checkpointing in the port (k_diffusion_tpu_torch): the HDiT's
``checkpointing`` over all levels, one level or one stack, and the ViT's
over every block. With dropout on, a training step under checkpointing
must equal the step without it exactly: the recompute replays the masks
the forward drew from the step's generator (``layers.remat``), as JAX's
``nn.remat`` replays its key. Which stacks run under checkpointing is held
against the JAX model's selection rule. CPU, float32, the kernels' plain
versions."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch.models import image_transformer_v2 as t_itv2

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def hdit_config(name, **model):
    config = KT.config.load_config(REPO / "configs" / name)
    config["model"].update({"input_size": [32, 32], "mapping_width": 64,
                            **model})
    config["optimizer"]["eps"] = 1e-4
    return config


# the flagship's level kinds (NA, NA, global) with dropout everywhere
FLAGSHIP = {"depths": [1, 1, 2], "widths": [64, 64, 128],
            "d_ffs": [128, 128, 256], "patch_size": [2, 2],
            "dropout_rate": [0.1, 0.2, 0.1], "mapping_dropout_rate": 0.1}
# shifted windows with an odd down depth, and dropout
SHIFTED = {"depths": [3, 2], "widths": [64, 128], "d_ffs": [128, 256],
           "patch_size": [2, 2],
           "self_attns": [{"type": "shifted-window", "d_head": 64,
                           "window_size": 4},
                          {"type": "global", "d_head": 64}],
           "dropout_rate": [0.1, 0.1]}
VIT = {"model": {"type": "image_transformer_v1", "input_channels": 3,
                 "input_size": [16, 16], "patch_size": 2, "depth": 3,
                 "width": 128, "dropout_rate": 0.1, "sigma_data": 0.5,
                 "sigma_min": 1e-2, "sigma_max": 80.0,
                 "sigma_sample_density": {"type": "lognormal", "mean": -1.2,
                                          "std": 1.2}},
       "dataset": {"type": "imagefolder"},
       "optimizer": {"eps": 1e-4}}


def configs():
    return {
        "flagship": hdit_config("config_oxford_flowers.json", **FLAGSHIP),
        "shifted": hdit_config("config_oxford_flowers_shifted_window.json",
                               **SHIFTED),
        "vit": KT.config.load_config(VIT),
    }


def seeded_model(config, **kw):
    """The model from seeded weights, noise in its zero-initialised
    projections (else it ignores its blocks)."""
    model = KT.config.make_model(config, device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def run_step(config, checkpointing, remat_levels=None, a_steps=2):
    """One training step (two microbatches, so that the generator's state
    after the first one's backward feeds the second's draws) from seeded
    weights; returns (loss, params, EMA params) after it."""
    model = seeded_model(config, checkpointing=checkpointing,
                         remat_levels=remat_levels)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(config, model))
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(config),
        KT.config.make_sample_density(config["model"]))
    size = config["model"]["input_size"]
    reals = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (a_steps, 2, *size, 3)).astype(np.float32))
    metrics = step(state, {"reals": reals},
                   torch.Generator().manual_seed(3), 0.5)
    return (metrics["loss"], [p.detach().clone() for p in model.parameters()],
            [p.clone() for p in state.ema_model.parameters()])


@pytest.fixture(scope="module")
def plain_steps():
    return {name: run_step(config, False) for name, config in configs().items()}


@pytest.mark.parametrize("name,levels", [
    ("flagship", None), ("flagship", (0,)), ("flagship", ("down_0",)),
    ("flagship", ("mid", 1)), ("shifted", None), ("shifted", (0,)),
    ("vit", None)])
def test_remat_step_equals_the_plain_step_exactly(plain_steps, name, levels):
    """Loss, every parameter after AdamW and the EMA copy, bit for bit,
    with dropout on in every level and the mapping network."""
    loss, params, ema = run_step(configs()[name], True, levels)
    want_loss, want_params, want_ema = plain_steps[name]
    assert torch.equal(loss, want_loss)
    for got, want in zip(params + ema, want_params + want_ema):
        assert torch.equal(got, want)


def test_dropout_is_live_in_the_remat_steps():
    """Another generator seed gives another output: the masks are drawn
    from it."""
    model = seeded_model(configs()["flagship"], checkpointing=True).train()
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    sigma = torch.ones(1)
    outs = [model(x, sigma, generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("levels,stacks", [
    (None, {"down_0", "down_1", "mid", "up_1", "up_0"}),
    ((0,), {"down_0", "up_0"}),
    (("down_0",), {"down_0"}),
    ((2, "up_1"), {"mid", "up_1"}),
    ((), set())])
def test_remat_levels_select_as_in_jax(monkeypatch, levels, stacks):
    """A level index selects both its down and its up stack (the mid level
    is the last index), a stack name only that stack; the JAX model's
    rule (``make_level``)."""
    config = configs()["flagship"]
    model = KT.config.make_model(config, device="cpu", checkpointing=True,
                                 remat_levels=levels)
    seen = []

    def record(fn, generator, x, pos, cond):
        seen.append(fn.func)
        return fn(x, pos, cond, generator)

    monkeypatch.setattr(t_itv2, "remat", record)
    model(torch.zeros((1, 32, 32, 3)), torch.ones(1))
    names = {name for name, m in model.named_children() if m in seen}
    assert {n.rsplit("_layer_", 1)[0] for n in names} == stacks
    # the stacks' every layer, none twice
    want = sum(1 for name, _ in model.named_children()
               if name.rsplit("_layer_", 1)[0] in stacks)
    assert len(seen) == len(names) == want


def test_no_checkpoint_without_autograd(monkeypatch):
    """Sampling (no grad) runs the layers as they are."""
    config = configs()["flagship"]
    model = KT.config.make_model(config, device="cpu", checkpointing=True)
    monkeypatch.setattr(t_itv2, "remat", None)
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 3)), torch.ones(1))


def test_remat_policy_raises_naming_the_roadmap():
    config = copy.deepcopy(configs()["flagship"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        KT.config.make_model(config, device="cpu", checkpointing=True,
                             remat_policy="save_attn_out")
