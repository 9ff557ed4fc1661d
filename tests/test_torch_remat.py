"""Gradient checkpointing in the port (k_diffusion_tpu_torch): the HDiT's
``checkpointing`` over all levels, one level or one stack, under each
``remat_policy``, and the ViT's over every block. With dropout on, a training step under checkpointing
must equal the step without it exactly: the recompute replays the masks
the forward drew from the step's generator (``layers.remat``), as JAX's
``nn.remat`` replays its key. Which stacks run under checkpointing is held
against the JAX model's selection rule. CPU, float32, the kernels' plain
versions."""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch.models import image_transformer_v2 as t_itv2
from k_diffusion_tpu_torch.ops.kernels import global_packed, na2d

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


def run_step(config, checkpointing, remat_levels=None, a_steps=2, **kw):
    """One training step (two microbatches, so that the generator's state
    after the first one's backward feeds the second's draws) from seeded
    weights; returns (loss, params, EMA params) after it."""
    model = seeded_model(config, checkpointing=checkpointing,
                         remat_levels=remat_levels, **kw)
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

    def record(fn, generator, x, pos, cond, policy=None):
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


# ---- remat_policy --------------------------------------------------------

POLICIES = ["save_attn_out", "save_attn", "save_attn_qkv_raw",
            "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "nothing_saveable",
            "everything_saveable"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("levels", [None, ("mid",)])
def test_remat_policy_step_equals_the_plain_step_exactly(plain_steps, policy,
                                                         levels):
    """Loss, every parameter after AdamW and the EMA copy, bit for bit,
    dropout on: a policy changes what is kept, not what is computed."""
    loss, params, ema = run_step(configs()["flagship"], True, levels,
                                 remat_policy=policy)
    want_loss, want_params, want_ema = plain_steps["flagship"]
    assert torch.equal(loss, want_loss)
    for got, want in zip(params + ema, want_params + want_ema):
        assert torch.equal(got, want)


def count_attention_forwards(monkeypatch):
    """Counts the attention forwards of the plain versions the HDiT's levels
    call (NA packed and per-head, global), outside their plain backwards,
    which recompute the attention as the kernels' backwards read it."""
    counts = {"forward": 0}
    for mod, fwd, bwd, reach in (
            (na2d, "reference", "reference_backward", 5),
            (na2d, "na2d_reference", "heads_reference_backward", 4),
            (global_packed, "reference", "reference_backward", 4)):
        plain = getattr(mod, fwd)

        def counted(*args, _plain=plain, **kw):
            counts["forward"] += 1
            return _plain(*args, **kw)

        def backward(q, k, v, dout, *args, _plain=plain, **kw):
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_() for t in (q, k, v)]
                return torch.autograd.grad(_plain(*inputs, *args, **kw),
                                           inputs, dout)

        monkeypatch.setattr(mod, fwd, counted)
        monkeypatch.setattr(mod, bwd, backward)
    return counts


@pytest.mark.parametrize("policy,per_layer", [
    (None, 2), ("nothing_saveable", 2), ("dots_saveable", 2),
    ("save_attn_out", 1), ("save_attn", 1), ("save_attn_qkv_raw", 1),
    ("everything_saveable", 1)])
def test_save_policies_run_the_attention_forward_once(monkeypatch, policy,
                                                      per_layer):
    """A step under a ``save_*`` policy runs each layer's attention forward
    once, the recompute reading the kept output; plain checkpointing runs
    it twice."""
    counts = count_attention_forwards(monkeypatch)
    config = configs()["flagship"]
    model = seeded_model(config, checkpointing=True, remat_policy=policy)
    layers = sum(1 for name, m in model.named_children()
                 if "_layer_" in name and hasattr(m, "self_attn"))
    den = KT.config.make_denoiser_wrapper(config)(model)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(7))
    loss = den.loss(x, torch.randn_like(x), torch.tensor([0.5, 3.0]),
                    generator=torch.Generator().manual_seed(8)).mean()
    assert counts["forward"] == layers
    loss.backward()
    assert counts["forward"] == layers * per_layer


@pytest.mark.parametrize("keep_qkv", [False, True])
def test_stash_keeps_what_the_policy_names(keep_qkv):
    """One kept tuple per attention call of the layer: output and lse, and
    q, k, v under "save_attn"; the recompute reads every one."""
    from k_diffusion_tpu_torch.ops.kernels import residuals
    q, k, v = (torch.randn((1, 8, 8, 64), generator=torch.Generator()
                           .manual_seed(i), requires_grad=True)
               for i in range(3))
    stash = residuals.Stash(keep_qkv)
    with residuals.recording(stash, replay=False):
        out = na2d.na2d_packed(q, k, v, 1, 3)
    assert len(stash.kept) == 1 and len(stash.kept[0]) == (5 if keep_qkv else 2)
    assert torch.equal(stash.kept[0][0], out)
    with residuals.recording(stash, replay=True):
        again = na2d.na2d_packed(q * 2, k, v, 1, 3)  # not recomputed
    assert torch.equal(again, out) and stash.next == 1


@pytest.mark.parametrize("name,match", [
    ("save_only_these_names", "policy factory"),
    ("offload_dot_with_no_batch_dims", "policy factory"),
    ("save_attn_everything", "not a remat policy"),
    ("dots", "not a remat policy")])
def test_other_remat_policy_names_raise(name, match):
    with pytest.raises(ValueError, match=match):
        KT.config.make_model(configs()["flagship"], device="cpu",
                             checkpointing=True, remat_policy=name)


# the JAX package's policy test model (tests/test_models.py): an NA level
# (head dim 16, kernel 3) and a global mid level (head dim 32)
def jax_tiny_model(**kw):
    j_itv2 = importlib.import_module(
        "k_diffusion_tpu.models.image_transformer_v2")
    return j_itv2.ImageTransformerDenoiserModelV2(
        levels=(j_itv2.LevelSpec(1, 32, 64,
                                 j_itv2.NeighborhoodAttentionSpec(16, 3), 0.0),
                j_itv2.LevelSpec(1, 64, 128, j_itv2.GlobalAttentionSpec(32),
                                 0.0)),
        mapping=j_itv2.MappingSpec(1, 32, 64, 0.0), in_channels=3,
        out_channels=3, patch_size=(2, 2), **kw)


def port_tiny_model(**kw):
    return t_itv2.ImageTransformerDenoiserModelV2(
        levels=(t_itv2.LevelSpec(1, 32, 64,
                                 t_itv2.NeighborhoodAttentionSpec(16, 3), 0.0),
                t_itv2.LevelSpec(1, 64, 128, t_itv2.GlobalAttentionSpec(32),
                                 0.0)),
        mapping=t_itv2.MappingSpec(1, 32, 64, 0.0), in_channels=3,
        out_channels=3, patch_size=(2, 2), device="cpu",
        generator=torch.Generator().manual_seed(0), **kw)


@pytest.mark.parametrize("policy", ["save_attn_out", "save_attn",
                                    "save_attn_qkv_raw", "dots_saveable"])
def test_remat_policy_step_matches_jax(policy):
    """tests/test_models.py's policy test, held across packages: the loss
    mean(model(x + 0.1, sigma) ** 2) and every gradient of the checkpointed
    model under the policy against the JAX model's, relative 2e-4."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from k_diffusion_tpu_torch import convert
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (2, 16, 16, 3))
    sigma = jnp.asarray([1.0, 3.0])
    j_model = jax_tiny_model(checkpointing=True, remat_policy=policy)
    params = jax_tiny_model().init(key, x, sigma)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p if p.ndim == 2 and p.shape[0] == 1 else
        np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)

    def loss_fn(p):
        return jnp.mean(j_model.apply({"params": p}, x + 0.1, sigma) ** 2)

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, want))
    port = port_tiny_model(checkpointing=True, remat_policy=policy).train()
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    names, tensors = zip(*port.named_parameters())
    loss = (port(torch.from_numpy(np.asarray(x)) + 0.1,
                 torch.from_numpy(np.asarray(sigma))) ** 2).mean()
    grads = torch.autograd.grad(loss, tensors)
    tol = 2e-4
    assert abs(float(loss) - float(want_loss)) <= tol * abs(float(want_loss))
    for name, g in zip(names, grads):
        w = want[name]
        assert np.abs(g.numpy() - w).max() <= tol * max(np.abs(w).max(),
                                                        1e-30), name
