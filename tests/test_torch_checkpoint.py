"""Inference checkpoints between the JAX package and the port
(k_diffusion_tpu_torch.checkpoint, utils.io), config from the metadata,
PNG output (utils.image) and the sample entry point on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from PIL import Image

import k_diffusion_tpu as K
import k_diffusion_tpu_torch as KT
from k_diffusion_tpu import checkpoint as jckpt
from k_diffusion_tpu_torch import checkpoint as tckpt
from k_diffusion_tpu_torch import convert
from k_diffusion_tpu_torch import sample as tsample
from k_diffusion_tpu_torch.utils import image as timage
from k_diffusion_tpu_torch.utils import io as tio

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "config_test_tiny.json"
UNET = REPO / "configs" / "config_cifar10.json"
UNET_OVERRIDES = {"input_size": [16, 16], "channels": [64, 64, 128],
                  "depths": [1, 1, 1], "self_attn_depths": [False, True, True],
                  "dropout_rate": 0.0}
# float32 on both sides, the bound of the model parity tests
TOL = 2e-4


def randomized(params, seed):
    """Seeded noise into every kernel (the zero-initialised ones too) and
    scale; the FourierFeatures bases stay as JAX drew them."""
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


@pytest.fixture(scope="module")
def tiny():
    """config_test_tiny's raw dict, the JAX model with randomized params."""
    raw = json.loads(TINY.read_text())
    model = K.config.make_model(K.config.load_config(raw))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)),
                                 class_cond=jnp.zeros((1,), jnp.int32))
    return raw, model, randomized(params["params"], 3)


def jax_forward(model, params, x, sigma, classes):
    return np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(sigma),
                                  class_cond=jnp.asarray(classes)))


def inputs():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
            np.float32([0.3, 4.0]), np.int32([0, 3]))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_jax_file_loads_into_the_port(tiny, tmp_path, dtype):
    """A file the JAX package writes (float32, or bfloat16 through
    ml_dtypes) loads into the port: the same tensors bit for bit, the same
    config, and the port's forward on them matches JAX's."""
    raw, model, params = tiny
    path = tmp_path / "tiny.safetensors"
    jckpt.save_inference(path, params, raw, dtype=dtype)
    state, config = tckpt.load_inference(path)
    assert config == raw
    flat = convert.flatten(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(flat)
    for name, value in flat.items():
        t = state[name]
        if dtype is None:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), value)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                value.astype(ml_dtypes.bfloat16).view(np.int16))
    port = KT.config.make_model(KT.config.load_config(path),
                                device="cpu").eval()
    port.load_state_dict(state)
    jparams, _ = jckpt.load_inference(path)
    jparams = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     jparams)
    x, sigma, classes = inputs()
    want = jax_forward(model, jparams, x, sigma, classes)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(sigma),
                   class_cond=torch.from_numpy(classes).long()).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16, "float16"])
def test_port_file_loads_into_jax(tiny, tmp_path, dtype):
    """A file the port writes loads into the JAX package: the same tensors
    in the dtype asked for, the config, and the JAX forward on them."""
    raw, model, params = tiny
    port = KT.config.make_model(KT.config.load_config(raw),
                                device="cpu").eval()
    port.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    path = tckpt.save_inference(tmp_path / "port.safetensors", port, raw,
                                dtype=dtype)
    jparams, config = jckpt.load_inference(path)
    assert config == raw
    want_dtype = {None: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
                  "float16": np.float16}[dtype]
    jflat = convert.flatten(jparams)
    state = port.state_dict()
    assert set(jflat) == set(state)
    for name, value in jflat.items():
        assert value.dtype == want_dtype, name
        np.testing.assert_array_equal(
            value, state[name].numpy().astype(want_dtype))
    if dtype is None:
        x, sigma, classes = inputs()
        want = jax_forward(model, params, x, sigma, classes)
        got = jax_forward(model, jparams, x, sigma, classes)
        np.testing.assert_array_equal(got, want)


def test_io_round_trip_and_header(tmp_path):
    """The port's own reader reads what its writer wrote, every dtype and
    shape (a scalar and an empty tensor included); the header is padded to
    8 bytes; the metadata reads without the tensors."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a/b": torch.randn((3, 5), generator=g),
               "c": torch.randn((4,), generator=g).to(torch.bfloat16),
               "d": torch.randn((2, 1, 3), generator=g).half(),
               "s": torch.tensor(2.5), "e": torch.zeros((0, 4))}
    path = tio.save_file(tensors, tmp_path / "t.safetensors",
                         metadata={"config": "{}", "n": 3})
    raw = path.read_bytes()
    header_len = int.from_bytes(raw[:8], "little")
    assert header_len % 8 == 0
    loaded, metadata = tio.load_file(path)
    assert metadata == {"config": "{}", "n": "3"}
    assert tio.get_safetensors_metadata(path) == metadata
    assert set(loaded) == set(tensors)
    for name, t in tensors.items():
        assert loaded[name].dtype == t.dtype and loaded[name].shape == t.shape
        assert torch.equal(loaded[name], t)
    with pytest.raises(ValueError, match="dtype"):
        tio.save_file({"i": torch.ones(2, dtype=torch.int32)},
                      tmp_path / "i.safetensors")


def test_load_config_reads_the_metadata(tiny, tmp_path):
    raw, _, params = tiny
    path = tmp_path / "tiny.safetensors"
    jckpt.save_inference(path, params, raw)
    assert KT.config.load_config(path) == KT.config.load_config(raw)
    assert (KT.utils.get_safetensors_metadata(path)
            == K.utils.get_safetensors_metadata(path))


@pytest.mark.parametrize("shape", [(6, 5, 3), (1, 4, 7, 3), (5, 6), (3, 4, 1),
                                   (4, 3, 4)])
def test_png_decodes_to_the_jax_values(tmp_path, shape):
    """utils.to_png, written with zlib and struct, decodes in Pillow to the
    pixels of the JAX package's to_pil_image, values outside [-1, 1] and
    exact halves included."""
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    x = (rng.standard_normal(shape) * 0.8).astype(np.float32)
    x.reshape(-1)[:3] = [1.5, -2.0, 1 / 255]  # clipped, clipped, a half
    path = timage.to_png(torch.from_numpy(x), tmp_path / "x.png")
    want = K.utils.to_pil_image(x)
    got = Image.open(path)
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def tiny_checkpoint(path):
    """config_test_tiny at seeded weights (zero-init projections filled)."""
    config = KT.config.load_config(TINY)
    g = torch.Generator().manual_seed(5)
    model = KT.config.make_model(config, device="cpu", generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("out_proj.kernel", "down_proj.kernel",
                              "patch_out.proj.kernel",
                              "mapping_linear.kernel")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return tckpt.save_inference(path, model, json.loads(TINY.read_text()))


# runs the module as ``python -m`` does, with the packages the card's
# machine lacks (and JAX) unimportable
AS_MAIN = """
import runpy, sys
for name in ("jax", "flax", "optax", "safetensors", "PIL"):
    sys.modules[name] = None
sys.argv = ["sample"] + sys.argv[1:]
runpy.run_module("k_diffusion_tpu_torch.sample", run_name="__main__")
"""


def test_sample_entry_point_writes_pngs(tmp_path):
    """``python -m k_diffusion_tpu_torch.sample --device cpu`` on
    config_test_tiny (class-conditional, through condcache under LMS)
    writes n PNGs, the last batch cut, with neither JAX, safetensors nor
    Pillow importable."""
    ckpt = tiny_checkpoint(tmp_path / "tiny.safetensors")
    prefix = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-c", AS_MAIN, "--checkpoint",
         str(ckpt), "-n", "6", "--batch-size", "4", "--steps", "4",
         "--prefix", str(prefix), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Wrote 6 images" in proc.stdout
    files = sorted(tmp_path.glob("out_*.png"))
    assert [f.name for f in files] == [f"out_{i:05}.png" for i in range(6)]
    for f in files:
        image = Image.open(f)
        assert image.mode == "RGB" and image.size == (32, 32)


@pytest.mark.parametrize("sampler", ["lms", "dpmpp_2m_sde", "heun",
                                     "dpm_2"])
def test_sample_pngs_hold_the_samples(tmp_path, monkeypatch, sampler):
    """In process: each PNG decodes to ``to_pil_image`` of its sample; the
    cached (lms, dpmpp_2m_sde, heun) and uncached (dpm_2) routes both."""
    ckpt = tiny_checkpoint(tmp_path / "tiny.safetensors")
    written, to_png = [], timage.to_png
    monkeypatch.setattr(KT.utils, "to_png",
                        lambda x, path: written.append(x) or to_png(x, path))
    paths = tsample.main(["--checkpoint", str(ckpt), "-n", "3",
                          "--batch-size", "3", "--steps", "3", "--prefix",
                          str(tmp_path / "s"), "--device", "cpu",
                          "--sampler", sampler])
    assert len(paths) == len(written) == 3
    for path, x in zip(paths, written):
        np.testing.assert_array_equal(
            np.asarray(Image.open(path)),
            np.asarray(K.utils.to_pil_image(x.numpy())))


def test_sample_entry_point_runs_the_unet(tmp_path):
    """The U-Net (config_cifar10 reduced) through make_denoiser_wrapper,
    DPM++(2M), from a checkpoint whose metadata holds the config."""
    raw = json.loads(UNET.read_text())
    raw["model"].update(UNET_OVERRIDES)
    model = KT.config.make_model(KT.config.load_config(raw), device="cpu",
                                 generator=torch.Generator().manual_seed(6))
    ckpt = tckpt.save_inference(tmp_path / "unet.safetensors", model, raw,
                                dtype="bfloat16")
    paths = tsample.main(["--checkpoint", str(ckpt), "-n", "2",
                          "--batch-size", "2", "--steps", "3", "--prefix",
                          str(tmp_path / "u"), "--device", "cpu",
                          "--sampler", "dpmpp_2m"])
    assert [p.name for p in paths] == ["u_00000.png", "u_00001.png"]
    assert Image.open(paths[0]).size == (16, 16)


def test_sample_needs_the_card_unless_asked(tmp_path, monkeypatch):
    """With no device named and no card, the entry point raises: it runs
    on the card and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = tiny_checkpoint(tmp_path / "tiny.safetensors")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsample.main(["--checkpoint", str(ckpt), "-n", "1",
                      "--prefix", str(tmp_path / "z")])
