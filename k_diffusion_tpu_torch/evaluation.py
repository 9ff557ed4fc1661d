"""FID and KID, and the feature extractors (counterpart of
k_diffusion_tpu/evaluation.py).

The metrics (unbiased squared MMD with the cubic polynomial kernel,
partitioned; the Frechet distance with an eigendecomposition square root)
run in float32 with TF32 off, as the JAX package runs them at "highest"
matmul precision.

Extractors load their weights from the local cache, where JAX's look; there
is no download:
- "inception": ``models.inception_v3.InceptionV3W`` on the extractor's
  device, with the weights of ``$XDG_CACHE_HOME/k-diffusion/
  inception-2015-12-05.pt`` (the StyleGAN-ADA torchscript) or, where that
  is absent, of its ``.npz`` export (``scripts/convert_inception_weights.py``);
- "inception_torch": that torchscript itself;
- "clip" and "dinov2": not ported; they raise, naming the weights, as the
  JAX package's do when its cache lacks them.
"""

import contextlib
import math
import os
from pathlib import Path

import torch

from . import parallel
from .models import inception_v3
from .utils import default_device

INCEPTION_FILE = "inception-2015-12-05.pt"
INCEPTION_URL = ("nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/"
                 "metrics/inception-2015-12-05.pt")


def inception_path(path=None):
    """``path``, or the cache's ``inception-2015-12-05.pt`` (under
    ``$XDG_CACHE_HOME``, default ``~/.cache``, in ``k-diffusion``)."""
    if path:
        return Path(path)
    cache = Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache"))
    return cache / "k-diffusion" / INCEPTION_FILE


# --- resize as jax.image.resize(..., "cubic") ---


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5, on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(n_in, n_out, device=None):
    """The (n_in, n_out) float32 matrix of ``jax.image.resize``'s cubic
    resampling along one axis (``compute_weight_mat`` with antialiasing):
    the kernel widened by the scale when downsampling, each output's
    weights renormalised to sum to 1, outputs whose sample lies outside the
    input zeroed. Identity where n_in == n_out, as JAX skips such an axis."""
    if n_in == n_out:
        return torch.eye(n_in, device=device)
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                          device=device)[:, None]).abs() \
        / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize(x, size):
    """NHWC ``x`` to (size[0], size[1]) as ``jax.image.resize(x, shape,
    "cubic")``: one product per axis with ``resize_weights``."""
    wh = resize_weights(x.shape[1], size[0], x.device)
    ww = resize_weights(x.shape[2], size[1], x.device)
    x = torch.einsum("bhwc,hH->bHwc", x.float(), wh)
    return torch.einsum("bHwc,wW->bHWc", x, ww)


# --- feature extractors ---


class InceptionV3Extractor:
    """The FID InceptionV3 (``models.inception_v3``) on ``device``.
    Input: NHWC in [-1, 1]. Preprocessing as the JAX extractor's: the cubic
    resize to 299 (``resize``), a single channel repeated to three, then
    x * 127.5 + 127.5 clamped to [0, 255]."""

    name = "inception"

    def __init__(self, path=None, state_dict=None, device=None):
        device = default_device(device)
        if state_dict is None:
            path = inception_path(path)
            if not path.exists() and path.with_suffix(".npz").exists():
                path = path.with_suffix(".npz")
            if not path.exists():
                raise RuntimeError(
                    f"Inception weights not found at {path} (or .npz); no "
                    f"network egress to download them: fetch {INCEPTION_URL} "
                    "elsewhere and drop it (or its scripts/"
                    "convert_inception_weights.py .npz export) at that path")
            state_dict = (inception_v3.load_npz_params(path)
                          if path.suffix == ".npz"
                          else inception_v3.load_torchscript_params(path))
        self.model = inception_v3.InceptionV3W(device=device)
        self.model.load_state_dict(state_dict)
        self.size = (299, 299)

    @torch.no_grad()
    def __call__(self, x):
        x = resize(x.to(next(self.model.buffers()).device), self.size)
        if x.shape[-1] == 1:
            x = x.expand(-1, -1, -1, 3)
        x = (x * 127.5 + 127.5).clamp(0, 255)
        with highest_precision():
            return self.model(x)


class TorchscriptInceptionExtractor:
    """The StyleGAN-ADA InceptionV3W torchscript itself, on ``device``.
    Input: NHWC in [-1, 1], resized with torch's antialiased bicubic as the
    JAX package's oracle does."""

    name = "inception"

    def __init__(self, path=None, device=None):
        path = inception_path(path)
        if not path.exists():
            raise RuntimeError(
                f"Inception weights not found at {path}; no network egress "
                f"to download them (reference URL: {INCEPTION_URL})")
        self.device = default_device(device)
        self.model = torch.jit.load(str(path), map_location=self.device).eval()
        self.size = (299, 299)

    @torch.no_grad()
    def __call__(self, x):
        t = x.to(self.device).permute(0, 3, 1, 2).float()
        t = torch.nn.functional.interpolate(
            t, self.size, mode="bicubic", align_corners=False, antialias=True)
        if t.shape[1] == 1:
            t = torch.cat([t] * 3, dim=1)
        t = (t * 127.5 + 127.5).clamp(0, 255)
        if hasattr(self.model, "layers"):
            return self.model.layers.forward(t).view(t.shape[0], -1).float()
        return self.model(t).float()


def _unported(name, model_name):
    raise RuntimeError(
        f"the {name} network is not in this package: its weights "
        f"({model_name}) are not in the local cache and its model is not "
        "ported")


def make_extractor(name, **kwargs):
    """"inception" or "inception_torch" (keywords: ``path``, ``device``);
    "clip" and "dinov2" raise as the JAX package's do without their
    weights. Any failure to build one raises RuntimeError."""
    try:
        if name == "inception":
            return InceptionV3Extractor(**kwargs)
        if name == "inception_torch":
            return TorchscriptInceptionExtractor(**kwargs)
        if name == "clip":
            _unported("CLIP", kwargs.get("model_name",
                                         "openai/clip-vit-base-patch16"))
        if name == "dinov2":
            _unported("DINOv2", kwargs.get("model_name",
                                           "facebook/dinov2-large"))
    except Exception as e:
        raise RuntimeError(
            f"feature extractor '{name}' unavailable (weights must already be "
            f"in the local cache; no network egress): {e}")
    raise ValueError(f"unknown feature extractor '{name}'")


def compute_features(sample_fn, extractor_fn, n, batch_size):
    """Draws ``n`` samples in batches of ``batch_size`` (``sample_fn(k)``
    returns at least k images) and returns their (n, d) features. ``n``
    counts the samples of all processes: with W of them, each draws
    ``ceil((n - got) / W)`` (at most ``batch_size``) a round, and each
    round's features are gathered in rank order
    (``parallel.all_gather_rows``), so that every process returns the same
    matrix, as the JAX package's ``process_allgather`` gives it."""
    world = parallel.process_count()
    feats, got = [], 0
    while got < n:
        cur = min(-(-(n - got) // world), batch_size)
        batch = extractor_fn(sample_fn(cur)[:cur])
        feats.append(parallel.all_gather_rows(batch) if world > 1 else batch)
        got += cur * world
    return torch.cat(feats)[:n]


# --- metrics ---


@contextlib.contextmanager
def highest_precision():
    """float32 products without TF32 (the JAX package's "highest")."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def polynomial_kernel(x, y):
    d = x.shape[-1]
    dot = x @ y.T
    return (dot / d + 1) ** 3


def squared_mmd(x, y, kernel=polynomial_kernel):
    """Unbiased squared MMD."""
    m, n = x.shape[-2], y.shape[-2]
    kxx, kyy, kxy = kernel(x, x), kernel(y, y), kernel(x, y)
    kxx_sum = kxx.sum() - kxx.diagonal().sum()
    kyy_sum = kyy.sum() - kyy.diagonal().sum()
    term_1 = kxx_sum / m / (m - 1)
    term_2 = kyy_sum / n / (n - 1)
    term_3 = kxy.sum() * 2 / m / n
    return term_1 + term_2 - term_3


def kid(x, y, max_size=5000):
    """Unbiased KID, averaged over partitions of at most ``max_size``."""
    x, y = x.float(), y.float()
    x_size, y_size = x.shape[0], y.shape[0]
    n_partitions = math.ceil(max(x_size / max_size, y_size / max_size))
    total = x.new_zeros([])
    with highest_precision():
        for i in range(n_partitions):
            cur_x = x[round(i * x_size / n_partitions):
                      round((i + 1) * x_size / n_partitions)]
            cur_y = y[round(i * y_size / n_partitions):
                      round((i + 1) * y_size / n_partitions)]
            total = total + squared_mmd(cur_x, cur_y)
    return total / n_partitions


def sqrtm_eig(a):
    """The square root of a symmetric PSD matrix by eigendecomposition."""
    vals, vecs = torch.linalg.eigh(a)
    return (vecs * vals.abs().sqrt()[None, :]) @ vecs.T


def fid(x, y, eps=1e-8):
    """The Frechet distance between the gaussians of two feature sets."""
    x, y = x.float(), y.float()
    with highest_precision():
        x_mean, y_mean = x.mean(0), y.mean(0)
        mean_term = ((x_mean - y_mean) ** 2).sum()
        eps_eye = torch.eye(x.shape[1], device=x.device) * eps
        x_cov = torch.cov(x.T) + eps_eye
        y_cov = torch.cov(y.T) + eps_eye
        x_cov_sqrt = sqrtm_eig(x_cov)
        cov_term = torch.trace(
            x_cov + y_cov - 2 * sqrtm_eig(x_cov_sqrt @ y_cov @ x_cov_sqrt))
        return mean_term + cov_term
