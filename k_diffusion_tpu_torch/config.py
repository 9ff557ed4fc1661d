"""JSON config loading and the model and denoiser factories (counterpart of
k_diffusion_tpu/config.py). The JAX package's module imports jax when it is
imported, so the port carries its own copy of the config logic.

The port covers the ``image_transformer_v2`` family: the other model types,
class and mapping conditioning, and the shifted-window and no-attention
levels raise ``NotImplementedError`` until they are ported.
"""

import json
import math
from functools import partial
from pathlib import Path

import torch

from . import denoiser


def deep_merge(base, head):
    """Recursive dict merge; ``head`` wins."""
    if isinstance(base, dict) and isinstance(head, dict):
        out = dict(base)
        for k, v in head.items():
            out[k] = deep_merge(base[k], v) if k in base else v
        return out
    return head


def round_to_power_of_two(x, tol):
    """Rounds x to the coarsest multiple-of-a-power-of-two within tol."""
    approxs = []
    for i in range(math.ceil(math.log2(x))):
        mult = 2 ** i
        approxs.append(round(x / mult) * mult)
    for approx in reversed(approxs):
        error = abs((approx - x) / x)
        if error <= tol:
            return approx
    return approxs[0]


_DEFAULTS_IMAGE_TRANSFORMER_V2 = {
    "model": {
        "mapping_width": 256, "mapping_depth": 2, "mapping_d_ff": None,
        "mapping_cond_dim": 0, "mapping_dropout_rate": 0.0, "d_ffs": None,
        "self_attns": None, "dropout_rate": None, "augment_wrapper": False,
        "skip_stages": 0, "has_variance": False,
    },
    "optimizer": {
        "type": "adamw", "lr": 5e-4, "betas": [0.9, 0.99], "eps": 1e-8,
        "weight_decay": 1e-4,
    },
}

_DEFAULTS = {
    "model": {
        "sigma_data": 1.0, "dropout_rate": 0.0, "augment_prob": 0.0,
        "loss_config": "karras", "loss_weighting": "karras", "loss_scales": 1,
    },
    "dataset": {
        "type": "imagefolder", "num_classes": 0, "cond_dropout_rate": 0.1,
    },
    "optimizer": {
        "type": "adamw", "lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8,
        "weight_decay": 1e-4,
    },
    "lr_sched": {"type": "constant", "warmup": 0.0},
    "ema_sched": {"type": "inverse", "power": 0.6667, "max_value": 0.9999},
}


def load_config(path_or_dict):
    """Loads a config from a JSON file or a dict and fills in the defaults,
    exactly as the JAX package does for ``image_transformer_v2``."""
    if isinstance(path_or_dict, dict):
        config = path_or_dict
    else:
        file = Path(path_or_dict)
        if file.suffix == ".safetensors":
            raise NotImplementedError(
                "configs from checkpoint metadata come with the port's "
                "checkpoint I/O")
        config = json.loads(file.read_text())
    if config["model"]["type"] != "image_transformer_v2":
        raise NotImplementedError(
            f"model type {config['model']['type']!r} comes with the port of "
            "the other model families")
    config = deep_merge(_DEFAULTS_IMAGE_TRANSFORMER_V2, config)
    model = config["model"]
    if not model["mapping_d_ff"]:
        model["mapping_d_ff"] = model["mapping_width"] * 3
    if not model["d_ffs"]:
        model["d_ffs"] = [w * 3 for w in model["widths"]]
    if not model["self_attns"]:
        n = len(model["widths"])
        model["self_attns"] = [
            {"type": "neighborhood", "d_head": 64, "kernel_size": 7}
            if i < n - 1 else {"type": "global", "d_head": 64}
            for i in range(n)]
    if model["dropout_rate"] is None:
        model["dropout_rate"] = [0.0] * len(model["widths"])
    elif isinstance(model["dropout_rate"], float):
        model["dropout_rate"] = [model["dropout_rate"]] * len(model["widths"])
    return deep_merge(_DEFAULTS, config)


def make_model(config, dtype=torch.float32, device=None, generator=None):
    """Builds the eval-mode HDiT from a loaded config. Parameters are
    float32 on ``device``, drawn from ``generator``; ``dtype`` is the compute
    dtype. Dropout rates are accepted and ignored: the port is eval-only."""
    from .models import image_transformer_v2 as itv2

    num_classes = config["dataset"]["num_classes"]
    config = config["model"]
    if num_classes or config["mapping_cond_dim"]:
        raise NotImplementedError(
            "class and mapping conditioning come with the port of the other "
            "conditioning paths")
    n = len(config["widths"])
    for key in ("depths", "d_ffs", "self_attns", "dropout_rate"):
        if len(config[key]) != n:
            raise ValueError(f"{key} has {len(config[key])} entries, widths {n}")
    levels = []
    for depth, width, d_ff, self_attn in zip(
            config["depths"], config["widths"], config["d_ffs"],
            config["self_attns"]):
        if self_attn["type"] == "global":
            spec = itv2.GlobalAttentionSpec(self_attn.get("d_head", 64))
        elif self_attn["type"] == "neighborhood":
            spec = itv2.NeighborhoodAttentionSpec(
                self_attn.get("d_head", 64), self_attn.get("kernel_size", 7))
        else:
            raise NotImplementedError(
                f"self attention type {self_attn['type']!r} comes with a "
                "later port")
        levels.append(itv2.LevelSpec(depth, width, d_ff, spec))
    mapping = itv2.MappingSpec(config["mapping_depth"],
                               config["mapping_width"], config["mapping_d_ff"])
    patch = config["patch_size"]
    patch = tuple(patch) if isinstance(patch, (list, tuple)) else (patch, patch)
    return itv2.ImageTransformerDenoiserModelV2(
        levels=tuple(levels), mapping=mapping,
        in_channels=config["input_channels"],
        out_channels=config["input_channels"], patch_size=patch,
        dtype=dtype, device=device, generator=generator)


def make_denoiser_wrapper(config):
    """The Karras preconditioner factory; variance and simple-loss wrappers
    come with the training port."""
    config = config["model"]
    if config.get("loss_config", "karras") != "karras" or config.get(
            "has_variance", False):
        raise NotImplementedError(
            "only the Karras denoiser without variance is ported")
    return partial(denoiser.Denoiser, sigma_data=config.get("sigma_data", 1.0),
                   weighting=config.get("loss_weighting", "karras"),
                   scales=config.get("loss_scales", 1))
