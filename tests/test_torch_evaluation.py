"""FID and KID in the port (k_diffusion_tpu_torch.evaluation,
models.inception_v3) against the JAX package's: the cubic resize against
``jax.image.resize``, InceptionV3W at 299 x 299 with seeded random weights
(the flax params exported in the torchscript's state-dict layout and
loaded by each package's loader), the whole extractor, the metrics, and
the extractors' refusals. CPU, float32."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_diffusion_tpu_torch import evaluation
from k_diffusion_tpu_torch.models import inception_v3

torch.set_num_threads(4)

j_evaluation = importlib.import_module("k_diffusion_tpu.evaluation")
j_inception = importlib.import_module("k_diffusion_tpu.models.inception_v3")

# the resize and the metrics: float32, other summation orders
OP_TOL = 1e-5
# 94 convolutions in float32, relative to the largest feature
NET_TOL = 1e-4


def close(got, want, tol=OP_TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


@pytest.mark.parametrize("shape,size", [
    ((2, 32, 32, 3), (299, 299)), ((1, 64, 48, 1), (299, 299)),
    ((1, 320, 320, 3), (299, 299)), ((1, 299, 100, 3), (299, 299)),
    ((1, 17, 23, 2), (9, 40))])
def test_resize_matches_jax_image_resize(shape, size):
    """Up, down (the kernel widened: antialiasing), one axis at its size,
    against jax.image.resize(..., "cubic"): within 2e-5 of its largest
    value, which is JAX's own distance from the float64 product of its
    weight matrices (6e-5 at 320 -> 299); the port is within 1e-6 of that
    product."""
    from jax._src.image import scale as j_scale
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]),
                            method="cubic")
    got = evaluation.resize(torch.from_numpy(x), size)
    close(got, want, 2e-5)
    mats = [np.asarray(j_scale.compute_weight_mat(
        n, m, m / n, 0.0, j_scale._kernels[j_scale.ResizeMethod.CUBIC],
        True), np.float64) if n != m else np.eye(n)
        for n, m in zip(shape[1:3], size)]
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64), *mats,
                      optimize=True)
    close(got, exact, 1e-6)


def test_resize_weights_are_jax_weight_matrices():
    from jax._src.image import scale as j_scale
    for n_in, n_out in ((32, 299), (320, 299), (7, 3)):
        want = j_scale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0,
            j_scale._kernels[j_scale.ResizeMethod.CUBIC], True)
        close(evaluation.resize_weights(n_in, n_out), want, 1e-6)


@pytest.fixture(scope="module")
def jax_params():
    """Seeded flax params with every batch norm made non-trivial."""
    params = j_inception.InceptionV3W().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3)))["params"]
    rng = np.random.default_rng(1)

    def fill(path, p):
        p = np.asarray(p)
        name = path[-1].key
        if name == "gamma":
            return (1 + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if name in ("beta", "mean"):
            return (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return p

    return jax.tree_util.tree_map_with_path(fill, params)


def torch_items(params):
    """The flax params as the torchscript's ordered state dict: OIHW
    kernels, each followed by its norm's torchvision-style names, and the
    unused classifier."""
    items = []
    for i, path in enumerate(j_inception.conv_path_order()):
        node = params
        for p in path:
            node = node[p]
        prefix = f"layers.{i}"
        items += [(f"{prefix}.conv.weight",
                   np.asarray(node["conv"]["kernel"]).transpose(3, 2, 0, 1)),
                  (f"{prefix}.bn.weight", np.asarray(node["gamma"])),
                  (f"{prefix}.bn.bias", np.asarray(node["beta"])),
                  (f"{prefix}.bn.running_mean", np.asarray(node["mean"])),
                  (f"{prefix}.bn.running_var", np.asarray(node["var"]))]
    items.append(("output.weight", np.zeros((1008, 2048), np.float32)))
    items.append(("output.bias", np.zeros((1008,), np.float32)))
    return items


def test_architecture_matches_jax():
    """94 convolutions in the same order and shapes (OIHW here, HWIO in
    JAX), and the blocks' widths."""
    want = [(o, i, h, w) for h, w, i, o in j_inception.conv_shape_order()]
    assert inception_v3.conv_shape_order() == want
    assert len(inception_v3.conv_path_order()) == inception_v3.N_CONVS == 94
    net = inception_v3.InceptionV3W(device="meta")
    assert net.mixed_7c.width == 2048 and net.mixed_6a.width == 768


def test_loader_reads_the_torchscript_layout(jax_params):
    state = inception_v3.params_from_torch_state_dict(torch_items(jax_params))
    for path in j_inception.conv_path_order():
        node = jax_params
        for p in path:
            node = node[p]
        name = ".".join(path)
        np.testing.assert_array_equal(
            state[f"{name}.weight"].numpy(),
            np.asarray(node["conv"]["kernel"]).transpose(3, 2, 0, 1))
        for key in ("gamma", "beta", "mean", "var"):
            np.testing.assert_array_equal(state[f"{name}.{key}"].numpy(),
                                          np.asarray(node[key]))
    with pytest.raises(ValueError, match="94"):
        inception_v3.params_from_torch_state_dict(
            [("w", np.zeros((32, 3, 3, 3), np.float32))])
    items = torch_items(jax_params)
    items[0] = (items[0][0], np.zeros((32, 3, 5, 5), np.float32))
    with pytest.raises(ValueError, match="kernel shape"):
        inception_v3.params_from_torch_state_dict(items)


def test_npz_export_loads_as_in_jax(jax_params, tmp_path):
    """The .npz of scripts/convert_inception_weights.py, read by both
    loaders: the same tensors."""
    items = torch_items(jax_params)
    path = tmp_path / "inception-2015-12-05.npz"
    np.savez(path, **{f"arr_{i:04d}_{k}": v for i, (k, v) in enumerate(items)})
    state = inception_v3.load_npz_params(path)
    want = j_inception.load_npz_params(path)
    for path_ in j_inception.conv_path_order():
        node = want
        for p in path_:
            node = node[p]
        np.testing.assert_array_equal(
            state[".".join(path_) + ".var"].numpy(), np.asarray(node["var"]))


def test_inception_features_match_jax(jax_params):
    """The network at 299 x 299, batch 2, on [0, 255] inputs."""
    x = np.random.default_rng(2).uniform(0, 255, (2, 299, 299, 3)).astype(
        np.float32)
    want = j_inception.InceptionV3W().apply({"params": jax_params},
                                            jnp.asarray(x))
    net = inception_v3.InceptionV3W(device="cpu")
    net.load_state_dict(inception_v3.params_from_torch_state_dict(
        torch_items(jax_params)))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    close(got, want, NET_TOL)
    assert np.abs(np.asarray(want)).max() > 0


def test_extractor_matches_jax(jax_params):
    """Resize from 32 x 32 and from a single channel, scaling, network:
    the extractor against JAX's on the same [-1, 1] images."""
    extractor = evaluation.InceptionV3Extractor(
        state_dict=inception_v3.params_from_torch_state_dict(
            torch_items(jax_params)), device="cpu")
    j_extractor = j_evaluation.InceptionV3FlaxExtractor(params=jax_params)
    for shape in ((2, 32, 32, 3), (1, 28, 28, 1)):
        x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
        close(extractor(torch.from_numpy(x)), j_extractor(jnp.asarray(x)),
              NET_TOL, str(shape))


def features(seed, n=200, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3
            + rng.standard_normal(d)).astype(np.float32)


def test_fid_kid_and_sqrtm_match_jax():
    x, y = features(4), features(5, 150)
    close(evaluation.fid(torch.from_numpy(x), torch.from_numpy(y)),
          j_evaluation.fid(x, y), 1e-4)
    close(evaluation.kid(torch.from_numpy(x), torch.from_numpy(y)),
          j_evaluation.kid(x, y), 1e-4)
    # several partitions
    close(evaluation.kid(torch.from_numpy(x), torch.from_numpy(y), 60),
          j_evaluation.kid(x, y, 60), 1e-4)
    a = np.cov(x.T).astype(np.float32) + np.eye(64, dtype=np.float32)
    close(evaluation.sqrtm_eig(torch.from_numpy(a)), j_evaluation.sqrtm_eig(a),
          1e-4)
    # fid(x, x) is 0 up to the float32 rounding of the terms that cancel in
    # it, whose sum trace(2 cov(x)) (about 742 here) sets its scale; the BLAS
    # decides the rounding, so hold it, and its distance to JAX's, to float32
    # precision of that scale
    scale = np.trace(2 * np.cov(x.T))
    self_fid = float(evaluation.fid(torch.from_numpy(x), torch.from_numpy(x)))
    assert abs(self_fid) <= 1e-4 * scale, (self_fid, scale)
    assert abs(self_fid - float(j_evaluation.fid(x, x))) <= 1e-4 * scale


def test_compute_features_matches_jax():
    """Batches of batch_size and a short last one, cut to n."""
    calls = []

    def sample_fn(n):
        calls.append(n)
        return torch.full((n + 1, 2), float(len(calls)))

    got = evaluation.compute_features(sample_fn, lambda x: x * 2, 7, 3)
    want = j_evaluation.compute_features(
        lambda n: jnp.full((n + 1, 2), 0.0), lambda x: x, 7, 3)
    assert calls == [3, 3, 1] and got.shape == want.shape == (7, 2)
    assert got[:, 0].tolist() == [2, 2, 2, 4, 4, 4, 6]


def test_make_extractor_refusals(tmp_path, monkeypatch):
    """No weights in the cache: RuntimeError naming the path; CLIP and
    DINOv2 name their weights; an unknown name is a ValueError."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="inception-2015-12-05"):
        evaluation.make_extractor("inception", device="cpu")
    with pytest.raises(RuntimeError, match="inception-2015-12-05"):
        evaluation.make_extractor("inception_torch", device="cpu")
    with pytest.raises(RuntimeError, match="openai/clip-vit-base-patch32"):
        evaluation.make_extractor("clip",
                                  model_name="openai/clip-vit-base-patch32")
    with pytest.raises(RuntimeError, match="facebook/dinov2-large"):
        evaluation.make_extractor("dinov2")
    with pytest.raises(ValueError, match="unknown feature extractor"):
        evaluation.make_extractor("lpips")


def test_inception_torch_runs_a_torchscript(tmp_path, jax_params):
    """"inception_torch" loads a torchscript with a ``layers`` network from
    the cache and returns its pooled output: here the port's network
    traced, whose state dict the InceptionV3 extractor also reads through
    ``load_torchscript_params``."""
    net = inception_v3.InceptionV3W(device="cpu")
    net.load_state_dict(inception_v3.params_from_torch_state_dict(
        torch_items(jax_params)))

    class Layers(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x.permute(0, 2, 3, 1))

    class Wrapper(torch.nn.Module):
        def __init__(self, layers):
            super().__init__()
            self.layers = layers

        def forward(self, x):
            return self.layers(x)

    layers = torch.jit.trace(Layers(), torch.zeros((1, 3, 299, 299)))
    path = tmp_path / "k-diffusion" / "inception-2015-12-05.pt"
    path.parent.mkdir()
    torch.jit.save(torch.jit.script(Wrapper(layers)), str(path))
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (1, 299, 299, 3)).astype(np.float32))
    got = evaluation.TorchscriptInceptionExtractor(path, device="cpu")(x)
    with torch.no_grad():
        want = net((x * 127.5 + 127.5).clamp(0, 255))
    close(got, want, 1e-5)
    extractor = evaluation.InceptionV3Extractor(path, device="cpu")
    close(extractor(x), want, 1e-5)
