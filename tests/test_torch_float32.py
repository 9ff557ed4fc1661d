"""Float32 compute on the card (``--mixed-precision no``) in the port, on the
CPU: which models take float32 on a CUDA device (every config, the ViT and
an HDiT with a neighborhood level of head dim 128, which no config ships);
the flash wrapper's dispatch of float32
operands to the float32 kernels (``kdt_flash_fwd_f32``,
``kdt_flash_bwd_f32``) with the library stood in for; the autograd node
carrying float32 residuals; and a small U-Net trained for 2 steps through
``train.run`` with ``--mixed-precision no --device cpu`` against JAX's
float32 step from the same numpy-seeded weights, batches and draws
(tests/test_torch_float32_transformers.py does the same for the ViT and
the HDiT)."""

import ctypes
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu import layout as j_layout
from k_diffusion_tpu.models import image_v1 as j_v1
from k_diffusion_tpu_torch import checkpoint, convert
from k_diffusion_tpu_torch import train as t_train
from k_diffusion_tpu_torch import training as t_training
from k_diffusion_tpu_torch.models import image_transformer_v1 as t_vit
from k_diffusion_tpu_torch.ops.kernels import _build, flash, residuals

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.json"))
# float32 on both sides: the tolerance of the train-step parity tests
TOL = 2e-4
# the train-step optimizer eps, as tests/test_torch_train.py explains
STEP_EPS = 1e-4


class _TorchCalled(AssertionError):
    pass


class _NoTorchCalls(torch.overrides.TorchFunctionMode):
    """Raises _TorchCalled at the first torch function called inside it (a
    parameter allocated, a tensor made) other than naming a device."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.device:
            return func(*args, **(kwargs or {}))
        raise _TorchCalled(f"{func} called")


def load(name):
    return KT.config.load_config(REPO / "configs" / name)


# ---- which models take float32 on the card ----------------------------------

# a small ViT beside the configs (no config ships one)
VIT = "vit"
# the flagship with head dim 128 at its neighborhood levels (no config ships
# one): its NA levels run the plain prologue and K11/K12 at head dim 128
NA_HEAD_DIM_128 = "oxford_flowers, neighborhood head dim 128"


def na_head_dim_128():
    config = load("config_oxford_flowers.json")
    for attn in config["model"]["self_attns"]:
        if attn["type"] == "neighborhood":
            attn["d_head"] = 128
    return config


def build_on_the_card(name, dtype):
    """Builds config ``name`` (or the small ViT, or the flagship with head
    dim 128 at its neighborhood levels) with ``dtype`` on a CUDA device,
    through make_model as the trainer does."""
    if name == VIT:
        return t_vit.ImageTransformerDenoiserModelV1(
            1, 64, 128, 3, 3, (2, 2), dtype=dtype, device="cuda")
    config = na_head_dim_128() if name == NA_HEAD_DIM_128 else load(name)
    return KT.config.make_model(config, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CONFIGS + [VIT, NA_HEAD_DIM_128])
def test_float32_on_the_card_routes_by_family(name, dtype, monkeypatch):
    """Every config, the ViT and the flagship with head dim 128 at its
    neighborhood levels build in bfloat16 and in float32 on a CUDA device:
    the dtype check passes and the build goes on to allocate its first
    parameter; in float32 ``card_dtypes`` says so and the trainer's
    ``--mixed-precision no`` turns TF32 on for cuBLAS and cuDNN. The three
    HDiT configs with neighborhood levels (head dim 64) are among them, and
    the head-dim-128 flagship, whose NA levels run K11 and K12 in float32
    at head dim 128."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with _NoTorchCalls(), pytest.raises(_TorchCalled):
        build_on_the_card(name, dtype)
    if name != VIT and dtype == torch.float32:
        config = na_head_dim_128() if name == NA_HEAD_DIM_128 else load(name)
        assert KT.config.card_dtypes(config) == (
            (torch.bfloat16, torch.float32), None)
        assert t_train.float32_on_the_card() == torch.float32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32


def test_float16_and_the_defaults():
    """float16 stays refused on the card for every family; the card's
    default stays bfloat16, the CPU's float32; on the CPU any dtype
    goes."""
    from k_diffusion_tpu_torch.utils import compute_dtype
    for dtypes in ((torch.bfloat16, torch.float32), (torch.bfloat16,)):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            compute_dtype("cuda", torch.float16, dtypes)
    assert compute_dtype("cuda") == torch.bfloat16
    assert compute_dtype("cuda", torch.float32) == torch.float32
    assert compute_dtype("cpu") == torch.float32
    assert compute_dtype("cpu", torch.bfloat16, (torch.bfloat16,),
                         "K5") == torch.bfloat16


# ---- the wrapper's dispatch -----------------------------------------------------

@pytest.fixture
def fake_library(monkeypatch):
    """The flash library stood in for: each launch records (entry, its
    arguments as Python values) and returns status 0; CPU tensors pass the
    CUDA check, so the wrapper's launch path runs here."""
    calls = []

    def launch(lib, entry, what, device, *args):
        calls.append((entry, [a.value if isinstance(a, ctypes.c_void_p)
                              else a for a in args]))

    monkeypatch.setattr(_build, "load", lambda name, **_: None)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    for attr in ("launches", "bwd_launches", "launches_f32",
                 "bwd_launches_f32"):
        monkeypatch.setattr(flash, attr, 0)
    return calls


def projection(dtype, b=2, s=5, heads=2, e=32):
    """q, k, v as strided views of one (b, s, 3, heads, e) projection, as
    the U-Net makes them, and a contiguous (b, s, heads, e) tensor."""
    qkv = torch.randn((b, s, 3, heads, e)).to(dtype)
    return (*qkv.unbind(2), torch.randn((b, s, heads, e)).to(dtype))


@pytest.mark.parametrize("dtype,fwd,bwd", [
    (torch.float32, "kdt_flash_fwd_f32", "kdt_flash_bwd_f32"),
    (torch.bfloat16, "kdt_flash_fwd", "kdt_flash_bwd")])
def test_flash_dispatches_by_dtype(fake_library, dtype, fwd, bwd):
    """float32 operands reach the float32 entry points, bfloat16 the bf16
    ones, with the views' batch and sequence strides, the shape and the
    scale; each dtype's launches are counted apart; the outputs and the
    backward's gradients are in the operands' dtype."""
    q, k, v, dout = projection(dtype)
    out, lse = flash.flash_forward(q, k, v, 0.25, save_lse=True)
    grads = flash.flash_backward(q, k, v, out, lse, dout, 0.25)
    (e_fwd, a_fwd), (e_bwd, a_bwd) = fake_library
    assert (e_fwd, e_bwd) == (fwd, bwd)
    strides = [q.stride(0), q.stride(1)]
    assert strides == [3 * 2 * 32 * 5, 3 * 2 * 32]
    assert a_fwd[5:11] == [2, 5, 2, 32, *strides]
    assert a_bwd[10:16] == [2, 5, 2, 32, *strides]
    assert a_fwd[11] == a_bwd[16] == 0.25
    assert a_fwd[:3] == [t.data_ptr() for t in (q, k, v)]
    # the float32 backward's TMA boxes and stores start on 16-byte bases
    assert all(p % 16 == 0 for p in a_bwd[:10])
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert all(g.dtype == dtype and g.is_contiguous() for g in grads)
    f32 = dtype == torch.float32
    assert (flash.launches, flash.launches_f32) == ((0, 1) if f32 else (1, 0))
    assert (flash.bwd_launches, flash.bwd_launches_f32) == (
        (0, 1) if f32 else (1, 0))


@pytest.mark.parametrize("case", ["mixed", "float16", "stride", "out dtype"])
def test_flash_refuses_what_no_kernel_takes(fake_library, case):
    """Mixed operand dtypes, float16, a float32 stride that is not a
    multiple of 4 elements (16 bytes) and a backward's out of another dtype
    raise by name, and nothing launches."""
    q, k, v, dout = projection(torch.float32)
    if case == "mixed":
        call, match = lambda: flash.flash_forward(
            q, k.bfloat16(), v), "takes q's torch.float32"
    elif case == "float16":
        call, match = lambda: flash.flash_forward(
            *(t.half() for t in (q, k, v))), "bfloat16 or float32"
    elif case == "stride":
        wide = torch.randn((2, 5, 2 * 32 + 2))[..., :64].reshape(2, 5, 2, 32)
        call, match = lambda: flash.flash_forward(
            wide, wide, wide), "multiples of 4"
    else:
        lse = torch.zeros((2, 2, 5))
        call, match = lambda: flash.flash_backward(
            q, k, v, dout.bfloat16(), lse, dout), "dtype"
    with pytest.raises(ValueError, match=match):
        call()
    assert not fake_library


def test_cpu_float32_takes_the_plain_version(fake_library):
    """float32 CPU tensors go to the plain version: no launch."""
    q, k, v, _ = projection(torch.float32)
    out = flash.flash_attention(q, k, v, 0.25)
    torch.testing.assert_close(out, flash.reference(q, k, v, 0.25))
    assert not fake_library


def test_attention_node_carries_float32_residuals():
    """The kernels' autograd node and a remat Stash keep float32 (out, lse)
    as they are: the recompute reads them back with no forward call, and
    the backward gets them, and dout, in float32."""
    *qkv, dout = projection(torch.float32)
    q, k, v = (t.clone().requires_grad_() for t in qkv)
    seen = []

    def forward(q, k, v):
        seen.append("forward")
        return flash.reference(q, k, v, 0.25), flash.reference_lse(q, k, v,
                                                                     0.25)

    def backward(q, k, v, out, lse, dout):
        seen.append((out.dtype, lse.dtype, dout.dtype))
        return flash.reference_backward(q, k, v, dout, 0.25)

    stash = residuals.Stash()
    with residuals.recording(stash, replay=False):
        first = residuals.attention(q, k, v, forward, backward)
    with residuals.recording(stash, replay=True):
        out = residuals.attention(q, k, v, forward, backward)
    assert stash.kept[0][0].dtype == stash.kept[0][1].dtype == torch.float32
    assert torch.equal(out, first)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert seen == ["forward", (torch.float32,) * 3]
    for got, want in zip(grads, flash.reference_backward(q, k, v, dout, 0.25)):
        torch.testing.assert_close(got, want)


# ---- the trainer against JAX ------------------------------------------------------

# config_cifar10.json cut to 2 levels: a 16 x 16 input, channels 32 and 64,
# self-attention (one head of 64) on the 8 x 8 level; dropout and
# augmentation off (their draws differ between the frameworks)
OVERRIDES = {"input_size": [16, 16], "channels": [32, 64], "depths": [1, 1],
             "self_attn_depths": [False, True], "dropout_rate": 0.0,
             "augment_prob": 0.0}
BATCH, STEPS = 2, 2
# a learning rate at which 2 AdamW steps move the params far past TOL
LR = 3e-3


def randomized(params, seed):
    """Seeded noise into every kernel and bias, the zero-initialised ones
    included; the FourierFeatures basis stays."""
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        if path[-1].key == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.sqrt(np.prod(p.shape[:-1]))
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(fill, params)


def test_float32_training_run_matches_jax(tmp_path, monkeypatch):
    """``train.run`` with ``--mixed-precision no --device cpu`` for 2 steps
    on the reduced U-Net (weights from ``--resume-inference``, synthetic
    data) against JAX's float32 step from the same weights: the trainer's
    batches and EMA decays are recorded, and each step's sigmas and noise
    are JAX's draws from its key, injected. Each step's loss, and the
    params and EMA after 2 steps, within 2e-4 (the params having moved
    by more than 10x that)."""
    config = K.config.load_config(REPO / "configs" / "config_cifar10.json")
    config["model"].update(OVERRIDES)
    config["optimizer"].update(eps=STEP_EPS, lr=LR)
    config["dataset"] = {"type": "synthetic", "length": BATCH}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    config = K.config.load_config(path)
    model = K.config.make_model(config)
    params = randomized(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        mapping_cond=jnp.zeros((1, 9)))["params"], 18)
    weights = tmp_path / "weights.safetensors"
    checkpoint.save_inference(
        weights, convert.state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, params)), config, dtype=torch.float32)

    density = K.config.make_sample_density(config["model"])
    shape = (1, BATCH, 16, 16, 3)
    keys = [jax.random.PRNGKey(30 + i) for i in range(STEPS)]
    draws = []
    for key in keys:  # the draws JAX's step makes from its key
        k_sigma, k_loop = jax.random.split(key)
        sigmas = np.array(density(k_sigma, (BATCH,), stratified=(0, 1)))
        k_noise, _, _ = jax.random.split(jax.random.fold_in(k_loop, 0), 3)
        folded = j_layout.fold_images(jnp.zeros(shape[1:])).shape
        noise = np.array(jax.random.normal(k_noise, folded)).reshape(shape)
        draws.append((sigmas, noise))

    seen = []
    make_step = t_training.make_train_step

    def recording(denoiser_factory, sample_density, **kw):
        def injected(shape, stratified=None, generator=None, device=None):
            return torch.from_numpy(draws[len(seen)][0]).reshape(shape)

        step = make_step(denoiser_factory, injected, **kw)

        def run(state, batch, generator, ema_decay):
            assert next(state.model.parameters()).dtype == torch.float32
            assert state.model.dtype == torch.float32
            metrics = step(state, batch, generator, ema_decay,
                           noise=torch.from_numpy(draws[len(seen)][1]))
            seen.append({"batch": {k: v.clone() for k, v in batch.items()},
                         "ema_decay": ema_decay,
                         "loss": float(metrics["loss"]),
                         "params": {k: v.clone() for k, v in
                                    state.model.state_dict().items()},
                         "ema": {k: v.clone() for k, v in
                                 state.ema_model.state_dict().items()}})
            return metrics
        return run

    monkeypatch.setattr(t_training, "make_train_step", recording)
    t_train.main(["--config", str(path), "--device", "cpu",
                  "--mixed-precision", "no", "--batch-size", str(BATCH),
                  "--num-workers", "1", "--name", str(tmp_path / "run"),
                  "--end-step", str(STEPS), "--save-every", "0",
                  "--demo-every", "0", "--evaluate-every", "0",
                  "--resume-inference", str(weights)])
    assert len(seen) == STEPS

    def apply_fn(p, x, sig, dropout_key, aug_cond=None, **kw):
        inner = K.augmentation.augment_wrapper_model_fn(
            lambda xi, si, **k: model.apply({"params": p}, xi, si, train=True,
                                            rngs={"dropout": dropout_key}, **k))
        return inner(x, sig, aug_cond=aug_cond, **kw)

    opt = K.training.make_optimizer(config, j_v1.param_group_labels(params))
    state = K.training.TrainState(
        step=jnp.int32(0), params=params, opt_state=opt.init(params),
        ema_params=jax.tree_util.tree_map(jnp.array, params))
    step = K.training.make_train_step(
        model, K.config.make_denoiser_wrapper(config), density, opt,
        apply_fn=apply_fn)
    for key, record in zip(keys, seen):
        batch = {k: jnp.asarray(v.numpy()) for k, v in record["batch"].items()}
        state, metrics = step(state, batch, key, record["ema_decay"])
        want = float(metrics["loss"])
        assert abs(record["loss"] - want) <= TOL * abs(want), (record["loss"],
                                                                want)
    before = convert.flatten(jax.tree_util.tree_map(np.asarray, params))
    moved = max(np.abs(seen[-1]["params"][k].numpy() - v).max() /
                np.abs(v).max() for k, v in before.items()
                if not k.endswith(".basis"))
    assert moved > 10 * TOL, moved
    for tree, kind in ((state.params, "params"), (state.ema_params, "ema")):
        want = convert.flatten(jax.tree_util.tree_map(np.asarray, tree))
        for name, got in seen[-1][kind].items():
            err = np.abs(got.numpy() - want[name]).max()
            assert err <= TOL * max(np.abs(want[name]).max(), 1e-30), (
                kind, name, err)
