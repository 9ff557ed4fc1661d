"""The port's optimizers other than AdamW (k_diffusion_tpu_torch.training,
``optim8bit``) against the JAX package's optax chains: clip + the 4-group
8-bit AdamW and SGD on config_test_tiny's HDiT, fed the same gradients on
both sides; and a resume from a training checkpoint, bit for bit. CPU,
float32."""

import copy
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import convert, optim8bit

torch.set_num_threads(2)

j_optim8bit = importlib.import_module("k_diffusion_tpu.optim8bit")
j_itv2 = importlib.import_module("k_diffusion_tpu.models.image_transformer_v2")

REPO = Path(__file__).resolve().parents[1]
STEPS = 5
# every parameter after STEPS updates, as one vector: relative L2. Not
# elementwise: the schedule's lr is float32 in JAX (1 - 0.99 ** 1 is
# 1e-6 off 0.01 there), so a zero-initialised kernel, whose values are a
# few lr, differs by 1e-6 of itself; and where an int8 moment rounds the
# other way, its element moves by lr * scale / sqrt(nu)
PARAM_TOL = 1e-6
# the int8 moments: an entry may round the other way where the clipped
# gradient (a global norm summed in another order) lands a value on a
# half; at most this share of them, by 1
MOMENT_FLIP_SHARE = 1e-3

SGD_CASES = {"momentum": {"momentum": 0.9},
             "nesterov_wd": {"momentum": 0.9, "nesterov": True,
                             "weight_decay": 1e-2},
             "plain_wd": {"momentum": 0.0, "weight_decay": 1e-2}}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def configs(optimizer):
    j_config = K.config.load_config(REPO / "configs" / "config_test_tiny.json")
    j_config["optimizer"].update(optimizer)
    t_config = KT.config.load_config(REPO / "configs" / "config_test_tiny.json")
    t_config["optimizer"].update(optimizer)
    return j_config, t_config


@pytest.fixture(scope="module")
def params():
    model = K.config.make_model(configs({})[0])
    return to_numpy(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.ones((1,)), class_cond=jnp.zeros((1,), jnp.int32))["params"])


def gradients(params, seed):
    """STEPS gradient trees, each tensor gaussian at its own scale, from
    1e-5 to 1e-1 (the Fourier bases, behind stop_gradient, get 0); their
    norm makes the clip act. Within a 2048-block the entries share a
    scale, as a layer's gradient does: where they span many decades the
    int8 nu of the small ones is 0 and their step is mu / eps, which no
    two float32 orders of summation reproduce."""
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map_with_path(
        lambda path, p: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(
            -5, -1) * (path[-1].key != "basis")).astype(np.float32),
        params) for _ in range(STEPS)]


def jax_run(j_config, params, grads):
    opt = K.training.make_optimizer(j_config, j_itv2.param_group_labels(params))
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return convert.flatten(to_numpy(params)), state


def port_model(t_config, params):
    model = KT.config.make_model(t_config, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert.state_dict_from_jax(params))
    return model


def port_run(model, optimizer, grads, counts):
    for count in counts:
        flat = convert.flatten(grads[count])
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(flat[name]).clone()  # the clip scales it
        optimizer.step(count)
        optimizer.zero_grad()


def assert_params_close(model, want):
    names, got = zip(*((n, p.detach().numpy().ravel())
                       for n, p in model.named_parameters()))
    got = np.concatenate(got)
    w = np.concatenate([want[n].ravel() for n in names])
    err = np.linalg.norm(got - w) / np.linalg.norm(w)
    assert err <= PARAM_TOL, err


def jax_moments(state):
    """{(param name, "mu" or "nu"): int8 q} from the 8-bit optax state."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [getattr(k, "name", getattr(k, "key", None)) for k in path]
        if names[-1] != "q":
            continue
        i = max(names.index("mu") if "mu" in names else -1,
                names.index("nu") if "nu" in names else -1)
        out[(".".join(names[i + 1:-1]), names[i])] = np.asarray(leaf)
    return out


def test_quantize_round_trip_and_half_to_even():
    """absmax / 127 per block, a zero block's scale 1, ties to even."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5] + [0.0] * 5)
    q, scale = optim8bit.quantize(x, 5)
    assert q.tolist() == [[127, 0, 2, 2, -2], [0] * 5]
    assert scale.flatten().tolist() == [1.0, 1.0]
    y = torch.randn(3000, generator=torch.Generator().manual_seed(0))
    q, scale = optim8bit.quantize(y, 2048)
    assert q.shape == (2, 2048) and scale.shape == (2, 1)
    back = optim8bit.dequantize(q, scale, y.shape)
    assert (back - y).abs().max() <= scale.max() / 2 + 1e-7


def test_quantize_matches_jax():
    x = np.random.default_rng(1).standard_normal(5000).astype(np.float32)
    want = j_optim8bit._quantize(jnp.asarray(x), 2048)
    q, scale = optim8bit.quantize(torch.from_numpy(x), 2048)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want.scale))


def test_adam8bit_matches_jax_over_five_steps(params):
    """Params within PARAM_TOL, every int8 moment within 1 and at most
    MOMENT_FLIP_SHARE of them off by 1; the four groups and the schedule
    as the JAX optimizer has them."""
    j_config, t_config = configs({"type": "adam8bit"})
    grads = gradients(params, 2)
    want, state = jax_run(j_config, params, grads)
    model = port_model(t_config, params)
    optimizer = KT.training.make_optimizer(t_config, model)
    assert optimizer.group_names() == ["wd", "no_wd", "mapping_wd",
                                       "mapping_no_wd"]
    port_run(model, optimizer, grads, range(STEPS))
    assert_params_close(model, want)
    moments = jax_moments(state)
    names = dict(model.named_parameters())
    flips = total = 0
    for (name, which), q in moments.items():
        if name.endswith(".basis"):  # a port buffer, never updated
            continue
        got = optimizer.optimizer.state[names[name]][which].numpy()
        diff = np.abs(got.astype(np.int32) - q.astype(np.int32))
        assert diff.max() <= 1, (name, which)
        flips += int((diff > 0).sum())
        total += diff.size
    assert total == sum(2 * 2048 * -(-p.numel() // 2048)
                        for p in names.values())
    assert flips <= MOMENT_FLIP_SHARE * total, (flips, total)


def test_adam8bit_state_is_about_two_bytes_a_parameter(params):
    """int8 mu and nu and one float32 scale per 2048-block of each."""
    _, t_config = configs({"type": "adam8bit"})
    model = port_model(t_config, params)
    optimizer = KT.training.make_optimizer(t_config, model)
    port_run(model, optimizer, gradients(params, 3), [0])
    n = sum(p.numel() for p in model.parameters())
    size = sum(t.numel() * t.element_size()
               for s in optimizer.optimizer.state.values()
               for key, t in s.items() if key != "step")
    blocks = sum(-(-p.numel() // 2048) for p in model.parameters())
    assert size == 2 * (blocks * 2048 + blocks * 4)
    assert size < 2.5 * n or n < 2048 * len(list(model.parameters()))


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sgd_matches_optax(params, case):
    """optax's sgd (trace: no dampening, optional nesterov) after the
    decayed weights, after the clip: params after five steps."""
    j_config, t_config = configs({"type": "sgd", "weight_decay": 0.0,
                                  **SGD_CASES[case]})
    grads = gradients(params, 4)
    want, _ = jax_run(j_config, params, grads)
    model = port_model(t_config, params)
    optimizer = KT.training.make_optimizer(t_config, model)
    port_run(model, optimizer, grads, range(STEPS))
    assert_params_close(model, want)


@pytest.mark.parametrize("optimizer", [
    {"type": "adam8bit"}, {"type": "sgd", **SGD_CASES["nesterov_wd"]}])
def test_resume_from_a_training_checkpoint_is_exact(params, tmp_path,
                                                    optimizer):
    """Three updates, a checkpoint, two more; against a state loaded from
    the checkpoint into a fresh model and optimizer that makes the same
    two: params, EMA and optimizer state bit for bit."""
    _, t_config = configs(optimizer)
    grads = gradients(params, 5)
    model = port_model(t_config, params)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(t_config, model))
    port_run(model, state.optimizer, grads, range(3))
    state.step = 3
    path = KT.checkpoint.save_checkpoint(tmp_path / "run_00000003.ckpt", state,
                                         {"step": 3})
    port_run(model, state.optimizer, grads, range(3, STEPS))
    fresh = port_model(t_config, params)
    restored, host = KT.checkpoint.load_checkpoint(
        path, KT.training.init_train_state(
            fresh, KT.training.make_optimizer(t_config, fresh)))
    assert restored.step == 3 and host == {"step": 3}
    port_run(fresh, restored.optimizer, grads, range(3, STEPS))
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    a, b = state.optimizer.optimizer.state, restored.optimizer.optimizer.state
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert set(a[p]) == set(b[q])
        for key in a[p]:
            assert torch.equal(a[p][key], b[q][key]), key


def test_state_dict_copies_the_moments(params):
    """Two optimizers loaded from one state dict update their own moments."""
    _, t_config = configs({"type": "adam8bit"})
    model = port_model(t_config, params)
    optimizer = KT.training.make_optimizer(t_config, model)
    grads = gradients(params, 6)
    port_run(model, optimizer, grads, [0])
    saved = optimizer.state_dict()
    other = KT.training.make_optimizer(t_config, copy.deepcopy(model))
    other.load_state_dict(saved)
    port_run(model, optimizer, grads, [1])
    first = next(iter(saved["optimizer"]["state"].values()))
    loaded = next(iter(other.optimizer.state.values()))
    assert loaded["mu"].dtype == torch.int8
    assert torch.equal(first["mu"], loaded["mu"])


def test_unknown_optimizer_type_raises(params):
    _, t_config = configs({"type": "lion"})
    with pytest.raises(ValueError, match="lion"):
        KT.training.make_optimizer(t_config, port_model(t_config, params))
