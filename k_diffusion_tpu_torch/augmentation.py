"""Karras (EDM) non-leaking augmentation, batched PyTorch (counterpart of
k_diffusion_tpu/augmentation.py): the 3 x 3 matrices and the 9-dim
conditioning of each image, the affine warp with an exact order-3
B-spline (its prefilter as one matrix product per axis), and the augment
wrapper of the U-Net.

The pipeline is split in two, as the sigma densities are
(``utils.random``):
``KarrasAugmentationPipeline.draw`` makes an image's 12 random draws (the
JAX pipeline's 12 key splits, in their order) from a ``torch.Generator``,
and ``apply`` is a pure function of those draws and the images. The tests
feed it the draws JAX makes from its keys. Everything runs on the images'
device: on the card the warp runs there, as JAX runs it on its device.

Coordinates follow the JAX package (and the reference, which names PIL's
(width, height) ``h, w``): matrices act on (x = column, y = row, 1).
"""

import math
from functools import lru_cache, reduce

import torch


def translate2d(tx, ty):
    """(..., 3, 3) translations by tensors (or numbers) ``tx``, ``ty``."""
    tx, ty = torch.broadcast_tensors(torch.as_tensor(tx, dtype=torch.float32),
                                     torch.as_tensor(ty, dtype=torch.float32))
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return torch.stack([torch.stack([o, z, tx], -1), torch.stack([z, o, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def scale2d(sx, sy):
    sx, sy = torch.broadcast_tensors(torch.as_tensor(sx, dtype=torch.float32),
                                     torch.as_tensor(sy, dtype=torch.float32))
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, z], -1), torch.stack([z, sy, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def rotate2d(theta):
    theta = torch.as_tensor(theta, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def reflect_index(i, n):
    """scipy/skimage 'reflect' (half-sample symmetric) boundary: ... 2 1 0
    0 1 2 ..."""
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def cubic_weights(t):
    """Catmull-Rom weights (a = -0.5) of the 4 taps around fractional t."""
    a = -0.5
    t2 = t * t
    t3 = t2 * t
    return torch.stack([a * (t3 - 2 * t2 + t),
                        (a + 2) * t3 - (a + 3) * t2 + 1,
                        -(a + 2) * t3 + (2 * a + 3) * t2 - a * t,
                        a * (t3 - t2)])


def bspline3_weights(t):
    """Cubic B-spline basis weights of the 4 taps around fractional t."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([(1 - 3 * t + 3 * t2 - t3) / 6,
                        (4 - 6 * t2 + 3 * t3) / 6,
                        (1 + 3 * t + 3 * t2 - 3 * t3) / 6,
                        t3 / 6])


@lru_cache(maxsize=None)
def prefilter_matrix(n, device=None):
    """The (n, n) float32 operator of the order-3 B-spline prefilter along
    one axis with 'reflect' boundaries: C^T diag(1 / h) C, with C the
    orthonormal DCT-II matrix and h = (2 + cos(pi k / n)) / 3 the B3 kernel
    [1, 4, 1] / 6 in that basis (the JAX package divides by h between
    ``dct`` and ``idct``). Built in float64 on the CPU, then cast, once
    for each (n, device): a training step reuses it with no host-to-device
    copy. Callers must not write to it.

    A matrix rather than a 2n-point FFT (torch has no DCT): it is one
    product per axis, with no complex intermediate, and at n <= 512 the
    product costs the card well under a millisecond a batch."""
    k = torch.arange(n, dtype=torch.float64)
    c = torch.cos(math.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    c = c * math.sqrt(2 / n)
    c[0] /= math.sqrt(2)
    h = (2 + torch.cos(math.pi * k / n)) / 3
    return (c.T @ (c / h[:, None])).to(device, torch.float32)


def spline_prefilter(images):
    """The exact cubic-B-spline prefilter of (..., H, W, C) images with
    'reflect' boundaries (scipy.ndimage.spline_filter(order=3,
    mode="reflect") of each image and channel), in float32."""
    h, w = images.shape[-3:-1]
    images = torch.einsum("ij,...jwc->...iwc",
                          prefilter_matrix(h, images.device), images)
    return torch.einsum("ij,...hjc->...hic",
                        prefilter_matrix(w, images.device), images)


def affine_warp(images, mats, order=3):
    """Warps (B, H, W, C) ``images`` by (B, 3, 3) affine ``mats`` (output
    coordinates = mat @ input coordinates), 'reflect' boundaries. Orders:
    3, the exact cubic B-spline (prefiltered); "catmull-rom", bicubic with
    no prefilter; 1, bilinear; 0, nearest. Float32."""
    b, h, w, _ = images.shape
    images = images.float()
    dev = images.device
    # inv_ex: torch.linalg.inv reads an error flag back to the host, which
    # would wait for the card every step
    inv = torch.linalg.inv_ex(mats.to(dev, torch.float32)).inverse
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    coords = torch.stack([xx, yy, torch.ones_like(xx)])      # (3, h, w)
    src = torch.einsum("bij,jhw->bihw", inv, coords)          # (b, 3, h, w)
    x_in, y_in = src[:, 0], src[:, 1]
    batch = torch.arange(b, device=dev)[:, None, None]

    def gather(iy, ix):
        return images[batch, reflect_index(iy, h), reflect_index(ix, w)]

    if order == 0:
        return gather(torch.round(y_in).long(), torch.round(x_in).long())
    x0, y0 = torch.floor(x_in), torch.floor(y_in)
    fx, fy = x_in - x0, y_in - y0
    x0, y0 = x0.long(), y0.long()
    if order == 1:
        fx, fy = fx[..., None], fy[..., None]
        out = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                out = out + wgt * gather(y0 + dy, x0 + dx)
        return out
    if order == 3:
        images = spline_prefilter(images)
        weight_fn = bspline3_weights
    elif order == "catmull-rom":
        weight_fn = cubic_weights
    else:
        raise ValueError(f"order {order!r}: 0, 1, 3 or 'catmull-rom'")
    wx, wy = weight_fn(fx), weight_fn(fy)                     # (4, b, h, w)
    out = 0.0
    for dy in range(4):
        row = 0.0
        for dx in range(4):
            row = row + wx[dx][..., None] * gather(y0 + dy - 1, x0 + dx - 1)
        out = out + wy[dy][..., None] * row
    return out


class KarrasAugmentationPipeline:
    """The EDM augmentation of (B, H, W, C) float images in [0, 1]:
    ``apply(draw(b, generator), images)`` gives (augmented, original, cond),
    the images in [-1, 1] and cond (B, 9)."""

    def __init__(self, a_prob=0.12, a_scale=2 ** 0.2, a_aniso=2 ** 0.2,
                 a_trans=1 / 8, disable_all=False, order=3):
        self.a_prob = a_prob
        self.a_scale = a_scale
        self.a_aniso = a_aniso
        self.a_trans = a_trans
        self.disable_all = disable_all
        self.order = order

    @staticmethod
    def draw(n, generator):
        """The 12 draws of each of ``n`` images from ``generator``, on its
        device, in the order of the JAX pipeline's key splits: {name: (n,)
        float32} ((n, 2) for a67). a0 and a1 are coin flips, a2, a5 and
        a67 standard normals, the rest uniforms in [0, 1); ``apply`` maps
        them as the JAX pipeline maps its key draws."""
        dev = generator.device

        def flip():
            return torch.randint(0, 2, (n,), generator=generator,
                                 device=dev).float()

        def uniform():
            return torch.rand((n,), generator=generator, device=dev)

        def normal(*shape):
            return torch.randn((n, *shape), generator=generator, device=dev)

        return {"a0": flip(), "p1": uniform(), "a1": flip(), "p2": uniform(),
                "a2": normal(), "p3": uniform(), "a3": uniform(),
                "p4": uniform(), "a4": uniform(), "a5": normal(),
                "p6": uniform(), "a67": normal(2)}

    def matrices(self, draws, height, width):
        """The (n, 3, 3) augmentation matrices and the (n, 9) cond of the
        draws for images of ``height`` x ``width``."""
        d = {k: v.float() for k, v in draws.items()}
        do = {i: (d[f"p{i}"] < self.a_prob).float() for i in (1, 2, 3, 4, 6)}
        a0 = d["a0"]
        a1 = d["a1"] * do[1]
        a2 = d["a2"] * do[2]
        a3 = (d["a3"] * 2 * math.pi - math.pi) * do[3]
        a4 = (d["a4"] * 2 * math.pi - math.pi) * do[4]
        a5 = d["a5"] * do[4]
        a6, a7 = (d["a67"] * do[6][:, None]).unbind(1)
        # the reference's PIL naming: h is the width
        h, w = width, height
        one = torch.ones_like(a0)
        mats = [
            translate2d(one * (h / 2 - 0.5), one * (w / 2 - 0.5)),
            scale2d(1 - 2 * a0, one),
            scale2d(one, 1 - 2 * a1),
            scale2d(self.a_scale ** a2, self.a_scale ** a2),
            rotate2d(-a3),
            rotate2d(a4),
            scale2d(self.a_aniso ** a5, self.a_aniso ** -a5),
            rotate2d(-a4),
            translate2d(self.a_trans * w * a6, self.a_trans * h * a7),
            translate2d(one * (-h / 2 + 0.5), one * (-w / 2 + 0.5)),
        ]
        cond = torch.stack([a0, a1, a2, torch.cos(a3) - 1, torch.sin(a3),
                            a5 * torch.cos(a4), a5 * torch.sin(a4), a6, a7],
                           -1)
        return reduce(torch.matmul, mats), cond

    def apply(self, draws, images):
        """(augmented, original, cond) of (B, H, W, C) ``images`` in [0, 1]
        under ``draws``. With ``disable_all`` the images pass unwarped and
        cond is zeros, as in the JAX pipeline."""
        images = images.float()
        if self.disable_all:
            cond = torch.zeros((images.shape[0], 9), device=images.device)
            return images * 2 - 1, images * 2 - 1, cond
        mats, cond = self.matrices(draws, *images.shape[1:3])
        warped = affine_warp(images, mats.to(images.device), self.order)
        return warped * 2 - 1, images * 2 - 1, cond.to(images.device)


def augment_wrapper_model_fn(inner_model):
    """Adapts a ``mapping_cond`` model (the U-Net) to take ``aug_cond`` (b,
    9) by packing it into ``mapping_cond``: zeros when ``aug_cond`` is not
    given, placed before any ``mapping_cond`` of the caller."""

    def model_fn(x, sigma, aug_cond=None, mapping_cond=None, **kwargs):
        if aug_cond is None:
            aug_cond = torch.zeros((x.shape[0], 9), dtype=x.dtype,
                                   device=x.device)
        if mapping_cond is None:
            mapping_cond = aug_cond
        else:
            mapping_cond = torch.cat([aug_cond, mapping_cond], dim=1)
        return inner_model(x, sigma, mapping_cond=mapping_cond, **kwargs)

    return model_fn
