"""InceptionV3W, the FID feature network (counterpart of
k_diffusion_tpu/models/inception_v3.py): the TF 2015 graph
("inception-2015-12-05") that the StyleGAN-ADA torchscript carries, as
``nn.Module``s computing in NCHW.

As the JAX module has it: the branch average pools leave padding out of
the divisor (TF ``SAME``, ``count_include_pad=False``); the last 8 x 8
block (``mixed_7c``) max-pools in its pool branch; batch norms are frozen
inference norms with TF's epsilon 1e-3. TF ``SAME`` padding appears only
at stride 1 and odd kernels here, where it is the symmetric k // 2. Input:
NHWC float in [0, 255] at 299 x 299, scaled to (x - 128) / 128; output:
the (batch, 2048) average-pooled features. The JAX package computes the
convolutions with ``lax.conv`` outside any Pallas kernel, so
``torch.nn.functional.conv2d`` is the port here.

Weights come from the StyleGAN-ADA torchscript's state dict or from the
``.npz`` that ``scripts/convert_inception_weights.py`` writes, mapped as
the JAX loader maps them: by insertion order, each 4-d tensor the next
conv kernel in architecture order (OIHW) and the 1-d tensors after it its
batch-norm parameters, classified by name; every kernel shape is checked.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def _c(out_ch, kh, kw, stride=1, padding="SAME"):
    return (out_ch, kh, kw, stride, padding)


def _block_a(pool_proj):
    """35 x 35 block (Mixed_5b/5c/5d)."""
    return (
        ("b1x1", None, (_c(64, 1, 1),), None),
        ("b5x5", None, (_c(48, 1, 1), _c(64, 5, 5)), None),
        ("b3x3dbl", None, (_c(64, 1, 1), _c(96, 3, 3), _c(96, 3, 3)), None),
        ("pool", ("avg", 1), (_c(pool_proj, 1, 1),), None),
    )


_BLOCK_B = (  # 35 -> 17 (Mixed_6a)
    ("b3x3", None, (_c(384, 3, 3, 2, "VALID"),), None),
    ("b3x3dbl", None,
     (_c(64, 1, 1), _c(96, 3, 3), _c(96, 3, 3, 2, "VALID")), None),
    ("pool", ("max", 2), (), None),
)


def _block_c(c7):
    """17 x 17 factorized-7x7 block (Mixed_6b..6e)."""
    return (
        ("b1x1", None, (_c(192, 1, 1),), None),
        ("b7x7", None, (_c(c7, 1, 1), _c(c7, 1, 7), _c(192, 7, 1)), None),
        ("b7x7dbl", None,
         (_c(c7, 1, 1), _c(c7, 7, 1), _c(c7, 1, 7), _c(c7, 7, 1),
          _c(192, 1, 7)), None),
        ("pool", ("avg", 1), (_c(192, 1, 1),), None),
    )


_BLOCK_D = (  # 17 -> 8 (Mixed_7a)
    ("b3x3", None, (_c(192, 1, 1), _c(320, 3, 3, 2, "VALID")), None),
    ("b7x7x3", None,
     (_c(192, 1, 1), _c(192, 1, 7), _c(192, 7, 1),
      _c(192, 3, 3, 2, "VALID")), None),
    ("pool", ("max", 2), (), None),
)


def _block_e(pool_kind):
    """8 x 8 block (Mixed_7b average pool; Mixed_7c max pool)."""
    return (
        ("b1x1", None, (_c(320, 1, 1),), None),
        ("b3x3", None, (_c(384, 1, 1),), (_c(384, 1, 3), _c(384, 3, 1))),
        ("b3x3dbl", None, (_c(448, 1, 1), _c(384, 3, 3)),
         (_c(384, 1, 3), _c(384, 3, 1))),
        ("pool", (pool_kind, 1), (_c(192, 1, 1),), None),
    )


_STEM = (  # 299 -> 35, a max pool after conv_2b and after conv_4a
    ("conv_1a", _c(32, 3, 3, 2, "VALID")),
    ("conv_2a", _c(32, 3, 3, 1, "VALID")),
    ("conv_2b", _c(64, 3, 3, 1, "SAME")),
    ("conv_3b", _c(80, 1, 1, 1, "VALID")),
    ("conv_4a", _c(192, 3, 3, 1, "VALID")),
)

_BLOCKS = (
    ("mixed_5b", _block_a(32)),
    ("mixed_5c", _block_a(64)),
    ("mixed_5d", _block_a(64)),
    ("mixed_6a", _BLOCK_B),
    ("mixed_6b", _block_c(128)),
    ("mixed_6c", _block_c(160)),
    ("mixed_6d", _block_c(160)),
    ("mixed_6e", _block_c(192)),
    ("mixed_7a", _BLOCK_D),
    ("mixed_7b", _block_e("avg")),
    ("mixed_7c", _block_e("max")),
)

N_CONVS = 94


class ConvBN(nn.Module):
    """Conv (no bias), frozen batch norm, ReLU. The weights are buffers:
    the network is evaluated, never trained. ``weight`` is OIHW."""

    def __init__(self, c_in, c_out, kh, kw, stride, padding, device=None):
        super().__init__()
        self.stride = stride
        self.padding = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
        self.register_buffer("weight", torch.zeros((c_out, c_in, kh, kw),
                                                   device=device))
        for name, fill in (("gamma", 1), ("beta", 0), ("mean", 0),
                           ("var", 1)):
            self.register_buffer(name, torch.full((c_out,), float(fill),
                                                  device=device))

    def forward(self, x):
        x = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        scale = self.gamma * torch.rsqrt(self.var + BN_EPS)
        x = (x - self.mean[:, None, None]) * scale[:, None, None] \
            + self.beta[:, None, None]
        return F.relu(x)


class InceptionBlock(nn.Module):
    """The branches of one block, concatenated along channels."""

    def __init__(self, spec, c_in, device=None):
        super().__init__()
        self.spec = spec
        self.width = 0
        for bname, _pool, convs, fork in spec:
            c = c_in
            for i, (ch, kh, kw, st, pad) in enumerate(convs):
                self.add_module(f"{bname}_{i}",
                                ConvBN(c, ch, kh, kw, st, pad, device))
                c = ch
            if fork is not None:
                for j, (ch, kh, kw, st, pad) in enumerate(fork):
                    self.add_module(f"{bname}_fork{j}",
                                    ConvBN(c, ch, kh, kw, st, pad, device))
                c = sum(f[0] for f in fork)
            self.width += c

    def forward(self, x):
        outs = []
        for bname, pool, convs, fork in self.spec:
            h = x
            if pool is not None:
                kind, stride = pool
                if stride == 2:
                    h = F.max_pool2d(h, 3, 2)
                elif kind == "avg":
                    h = F.avg_pool2d(h, 3, 1, padding=1,
                                     count_include_pad=False)
                else:
                    h = F.max_pool2d(h, 3, 1, padding=1)
            for i in range(len(convs)):
                h = getattr(self, f"{bname}_{i}")(h)
            if fork is not None:
                h = torch.cat([getattr(self, f"{bname}_fork{j}")(h)
                               for j in range(len(fork))], dim=1)
            outs.append(h)
        return torch.cat(outs, dim=1)


class InceptionV3W(nn.Module):
    """The FID InceptionV3: NHWC float in [0, 255] at 299 x 299 ->
    (batch, 2048) features. Its buffers are zero until weights are loaded
    (``load_state_dict(params_from_torch_state_dict(...))``); they go to
    ``device``."""

    def __init__(self, device=None):
        super().__init__()
        c = 3
        for name, (ch, kh, kw, st, pad) in _STEM:
            self.add_module(name, ConvBN(c, ch, kh, kw, st, pad, device))
            c = ch
        for name, spec in _BLOCKS:
            block = InceptionBlock(spec, c, device)
            self.add_module(name, block)
            c = block.width

    def forward(self, x):
        x = ((x - 128.0) / 128.0).permute(0, 3, 1, 2)
        for name, _ in _STEM:
            x = getattr(self, name)(x)
            if name in ("conv_2b", "conv_4a"):
                x = F.max_pool2d(x, 3, 2)
        for name, _ in _BLOCKS:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def conv_path_order():
    """The ConvBN module names in architecture order (N_CONVS of them): the
    order the state-dict loader maps kernels onto."""
    paths = [name for name, _ in _STEM]
    for block_name, spec in _BLOCKS:
        for bname, _pool, convs, fork in spec:
            paths += [f"{block_name}.{bname}_{i}" for i in range(len(convs))]
            if fork is not None:
                paths += [f"{block_name}.{bname}_fork{j}"
                          for j in range(len(fork))]
    assert len(paths) == N_CONVS
    return paths


def conv_shape_order():
    """The OIHW kernel shapes in architecture order."""
    model = InceptionV3W(device="meta")
    return [tuple(model.get_submodule(p).weight.shape)
            for p in conv_path_order()]


def params_from_torch_state_dict(items):
    """The network's state dict from an ordered iterable of (name, array):
    a torch ``state_dict().items()`` or an ``.npz``'s items. 4-d tensors
    are the conv kernels (OIHW) in architecture order; the 1-d tensors
    after a kernel, of its width, are its batch norm's: 'mean' in the name
    the running mean, 'var' the running variance, 'beta' or 'bias' the
    shift, anything else the scale. 2-d tensors (the unused 1008-way
    classifier) are skipped. Raises ValueError for another architecture."""
    units = []
    for name, t in items:
        t = np.asarray(t)
        if t.ndim == 4:
            units.append({"weight": t, "_name": name})
        elif t.ndim == 1 and units:
            u = units[-1]
            if t.shape[0] != u["weight"].shape[0]:
                continue  # not this conv's norm (the classifier's bias)
            ln = name.lower()
            key = ("mean" if "mean" in ln else "var" if "var" in ln
                   else "beta" if "beta" in ln or "bias" in ln else "gamma")
            u[key] = t
    if len(units) != N_CONVS:
        raise ValueError(
            f"expected {N_CONVS} conv kernels in the state dict, found "
            f"{len(units)}: not an InceptionV3W artifact")
    state = {}
    for path, shape, u in zip(conv_path_order(), conv_shape_order(), units):
        if tuple(u["weight"].shape) != shape:
            raise ValueError(f"conv at {path} ({u['_name']}): kernel shape "
                             f"{u['weight'].shape} != expected {shape}")
        out_ch = shape[0]
        defaults = {"gamma": np.ones(out_ch), "beta": np.zeros(out_ch),
                    "mean": np.zeros(out_ch), "var": np.ones(out_ch)}
        for key in ("weight", "gamma", "beta", "mean", "var"):
            state[f"{path}.{key}"] = torch.as_tensor(
                np.asarray(u.get(key, defaults.get(key)), np.float32))
    return state


def load_torchscript_params(path):
    """The state dict from the StyleGAN-ADA ``inception-2015-12-05.pt``
    torchscript."""
    model = torch.jit.load(str(path), map_location="cpu")
    return params_from_torch_state_dict(
        (k, v.detach().cpu().numpy()) for k, v in model.state_dict().items())


def load_npz_params(path):
    """The state dict from an ``.npz`` of (name, array) in order."""
    with np.load(path) as z:
        return params_from_torch_state_dict(list(z.items()))
