"""JSON config loading and the model, denoiser, sigma density, LR and EMA
schedule factories (counterpart of k_diffusion_tpu/config.py). The JAX
package's module imports jax when it is imported, so the port carries its
own copy of the config logic.

The port covers the ``image_transformer_v2`` family (HDiT, with class
conditioning in the forward) and the ``image_v1`` family (U-Net). The ViT
(``image_transformer_v1``), the HDiT's mapping conditioning and
shifted-window and no-attention levels, the U-Net's cross-attention, and
the variance head raise ``NotImplementedError`` until they are ported.

``make_model``, ``make_sample_density``'s densities and
``sampling.get_sigmas_karras`` put their tensors on the card unless the
caller names a device (``utils.default_device``); a model on the card
computes in bfloat16 (``utils.compute_dtype``).
"""

import json
import math
from functools import partial
from pathlib import Path

import torch

from . import augmentation, denoiser, utils


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


_DEFAULTS_IMAGE_V1 = {
    "model": {
        "patch_size": 1, "augment_wrapper": True, "mapping_cond_dim": 0,
        "unet_cond_dim": 0, "cross_cond_dim": 0, "cross_attn_depths": None,
        "skip_stages": 0, "has_variance": False,
    },
    "optimizer": {
        "type": "adamw", "lr": 1e-4, "betas": [0.95, 0.999], "eps": 1e-6,
        "weight_decay": 1e-3,
    },
}

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
    """Loads a config from a JSON file, a dict or the metadata of a
    safetensors inference checkpoint and fills in the defaults,
    exactly as the JAX package does for ``image_v1`` and
    ``image_transformer_v2``."""
    if isinstance(path_or_dict, dict):
        config = path_or_dict
    else:
        file = Path(path_or_dict)
        if file.suffix == ".safetensors":
            config = json.loads(utils.get_safetensors_metadata(file)["config"])
        else:
            config = json.loads(file.read_text())
    if config["model"]["type"] == "image_v1":
        return deep_merge(_DEFAULTS, deep_merge(_DEFAULTS_IMAGE_V1, config))
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


def make_model(config, dtype=None, device=None, generator=None):
    """Builds the U-Net (``image_v1``) or the HDiT (``image_transformer_v2``)
    from a loaded config. Parameters are float32 on ``device`` (default: the
    card), drawn from ``generator``; ``dtype`` is the compute dtype
    (default: bfloat16 on the card, float32 elsewhere; on the card nothing
    else, see ``utils.compute_dtype``). The dropout rates apply under
    ``model.train()``, PyTorch's default mode: call ``model.eval()`` to
    sample."""
    device = utils.default_device(device)
    dtype = utils.compute_dtype(device, dtype)
    num_classes = config["dataset"]["num_classes"]
    config = config["model"]
    if config["type"] == "image_v1":
        return _make_image_v1(config, dtype, device, generator)
    if config["type"] != "image_transformer_v2":
        raise NotImplementedError(
            f"model type {config['type']!r} comes with the port of the other "
            "model families")
    from .models import image_transformer_v2 as itv2

    if config["mapping_cond_dim"]:
        raise NotImplementedError(
            "the HDiT's mapping conditioning comes with a later port")
    n = len(config["widths"])
    for key in ("depths", "d_ffs", "self_attns", "dropout_rate"):
        if len(config[key]) != n:
            raise ValueError(f"{key} has {len(config[key])} entries, widths {n}")
    levels = []
    for depth, width, d_ff, self_attn, dropout in zip(
            config["depths"], config["widths"], config["d_ffs"],
            config["self_attns"], config["dropout_rate"]):
        if self_attn["type"] == "global":
            spec = itv2.GlobalAttentionSpec(self_attn.get("d_head", 64))
        elif self_attn["type"] == "neighborhood":
            spec = itv2.NeighborhoodAttentionSpec(
                self_attn.get("d_head", 64), self_attn.get("kernel_size", 7))
        else:
            raise NotImplementedError(
                f"self attention type {self_attn['type']!r} comes with a "
                "later port")
        levels.append(itv2.LevelSpec(depth, width, d_ff, spec, dropout))
    mapping = itv2.MappingSpec(config["mapping_depth"],
                               config["mapping_width"], config["mapping_d_ff"],
                               config["mapping_dropout_rate"])
    patch = config["patch_size"]
    patch = tuple(patch) if isinstance(patch, (list, tuple)) else (patch, patch)
    return itv2.ImageTransformerDenoiserModelV2(
        levels=tuple(levels), mapping=mapping,
        in_channels=config["input_channels"],
        out_channels=config["input_channels"], patch_size=patch,
        num_classes=num_classes + 1 if num_classes else 0,
        dtype=dtype, device=device, generator=generator)


def _make_image_v1(config, dtype, device, generator):
    """The U-Net as the JAX package builds it; the augment wrapper's 9
    features widen ``mapping_cond``."""
    from .models import image_v1

    if config["cross_cond_dim"]:
        raise NotImplementedError(
            "the U-Net's cross-attention (cross_cond_dim > 0) comes with a "
            "later port")
    if config["has_variance"]:
        raise NotImplementedError(
            "the U-Net's variance head (has_variance) comes with a later port")
    return image_v1.ImageDenoiserModelV1(
        c_in=config["input_channels"], feats_in=config["mapping_out"],
        depths=tuple(config["depths"]), channels=tuple(config["channels"]),
        self_attn_depths=tuple(config["self_attn_depths"]),
        mapping_cond_dim=config["mapping_cond_dim"]
        + (9 if config["augment_wrapper"] else 0),
        unet_cond_dim=config["unet_cond_dim"],
        dropout_rate=config["dropout_rate"], patch_size=config["patch_size"],
        skip_stages=config["skip_stages"], dtype=dtype, device=device,
        generator=generator)


def make_denoiser_wrapper(config):
    """Karras or simple loss wrapper factory: ``factory(model) ->
    denoiser``. A U-Net with ``augment_wrapper`` is wrapped in
    ``augmentation.augment_wrapper_model_fn`` first, as the JAX ``train.py``
    wraps it, so that the denoiser takes ``aug_cond``. The variance head
    (``has_variance``) comes with a later model port."""
    factory = _denoiser_factory(config["model"])
    if config["model"].get("type") == "image_v1" and \
            config["model"].get("augment_wrapper"):
        return lambda model: factory(
            augmentation.augment_wrapper_model_fn(model))
    return factory


def _denoiser_factory(config):
    sigma_data = config.get("sigma_data", 1.0)
    if config.get("has_variance", False):
        raise NotImplementedError(
            "DenoiserWithVariance and a model with a variance head are not "
            "ported yet")
    loss_config = config.get("loss_config", "karras")
    if loss_config == "karras":
        return partial(denoiser.Denoiser, sigma_data=sigma_data,
                       weighting=config.get("loss_weighting", "karras"),
                       scales=config.get("loss_scales", 1))
    if loss_config == "simple":
        return partial(denoiser.SimpleLossDenoiser, sigma_data=sigma_data)
    raise ValueError("Unknown loss config type")


def make_sample_density(config):
    """Training-time sigma density factory from the ``model`` config
    section, as the JAX package's. Returns
    ``fn(shape, stratified=None, generator=None, device=None) -> sigmas``,
    the sigmas on ``device`` (default: the card)."""
    density = _sample_density(config)

    def sample(shape, stratified=None, generator=None, device=None):
        return density(shape, stratified=stratified, generator=generator,
                       device=utils.default_device(device))

    return sample


def _sample_density(config):
    sd_config = config["sigma_sample_density"]
    sigma_data = config["sigma_data"]
    kind = sd_config["type"]
    if kind == "lognormal":
        loc = sd_config["mean"] if "mean" in sd_config else sd_config["loc"]
        scale = sd_config["std"] if "std" in sd_config else sd_config["scale"]
        return partial(utils.rand_log_normal, loc=loc, scale=scale)
    if kind == "loglogistic":
        return partial(utils.rand_log_logistic,
                       loc=sd_config.get("loc", math.log(sigma_data)),
                       scale=sd_config.get("scale", 0.5),
                       min_value=sd_config.get("min_value", 0.0),
                       max_value=sd_config.get("max_value", float("inf")))
    if kind == "loguniform":
        return partial(utils.rand_log_uniform,
                       min_value=sd_config.get("min_value", config["sigma_min"]),
                       max_value=sd_config.get("max_value", config["sigma_max"]))
    if kind in {"v-diffusion", "cosine"}:
        return partial(utils.rand_v_diffusion, sigma_data=sigma_data,
                       min_value=sd_config.get("min_value", 1e-3),
                       max_value=sd_config.get("max_value", 1e3))
    if kind == "split-lognormal":
        loc = sd_config["mean"] if "mean" in sd_config else sd_config["loc"]
        scale_1 = sd_config["std_1"] if "std_1" in sd_config else sd_config["scale_1"]
        scale_2 = sd_config["std_2"] if "std_2" in sd_config else sd_config["scale_2"]

        def density(shape, stratified=None, generator=None, device=None):
            # never stratified, as in the JAX package and the reference
            return utils.rand_split_log_normal(shape, loc, scale_1, scale_2,
                                               generator, device)

        return density
    if kind == "cosine-interpolated":
        return partial(
            utils.rand_cosine_interpolated,
            image_d=sd_config.get("image_d", max(config["input_size"])),
            noise_d_low=sd_config.get("noise_d_low", 32),
            noise_d_high=sd_config.get("noise_d_high", max(config["input_size"])),
            sigma_data=sigma_data,
            min_value=sd_config.get("min_value", min(config["sigma_min"], 1e-3)),
            max_value=sd_config.get("max_value", max(config["sigma_max"], 1e3)))
    raise ValueError("Unknown sample density type")


def make_lr_schedule(config):
    """LR schedule factory from the lr_sched config section."""
    sched_config = config["lr_sched"]
    base_lr = config["optimizer"]["lr"]
    if sched_config["type"] == "constant":
        return utils.constant_lr_with_warmup(base_lr, warmup=sched_config["warmup"])
    if sched_config["type"] == "inverse":
        return utils.inverse_lr(
            base_lr, inv_gamma=sched_config["inv_gamma"],
            power=sched_config["power"], warmup=sched_config["warmup"],
            min_lr=sched_config.get("min_lr", 0.0))
    if sched_config["type"] == "exponential":
        return utils.exponential_lr(
            base_lr, num_steps=sched_config["num_steps"],
            decay=sched_config.get("decay", 0.5), warmup=sched_config["warmup"],
            min_lr=sched_config.get("min_lr", 0.0))
    raise ValueError("Unknown lr_sched type")


def make_ema_sched(config):
    """EMA decay schedule factory."""
    sched_config = config["ema_sched"]
    if sched_config["type"] == "inverse":
        return utils.EMAWarmup(power=sched_config["power"],
                               max_value=sched_config["max_value"])
    raise ValueError("Unknown ema_sched type")
