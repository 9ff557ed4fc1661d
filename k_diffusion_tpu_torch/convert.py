"""JAX parameter trees -> the port's state_dicts: a model's params, and a
JAX ``TrainState``'s params and EMA params into the port's train state; and
between the port's names and the ``/``-joined flax paths of the JAX
package's safetensors files (``checkpoint.py``).

The port's parameter names mirror the flax tree and keep its layouts (Dense
kernels (in, out), the U-Net's convolution kernels (kh, kw, in, out),
FourierFeatures ``basis`` (in, out // 2)), so conversion of every model
family (the HDiT, the ViT, the U-Net) is a rename: nested keys joined
with dots, arrays copied as they are.
"""

import numpy as np
import torch


def flatten(tree, prefix=""):
    """{"a": {"b": x}} -> {"a.b": x}."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten(value, name + "."))
        else:
            flat[name] = value
    return flat


def names_from_flax_paths(flat):
    """{"a/b/c": x} (the JAX package's ``_flatten_params`` names) ->
    {"a.b.c": x}, the port's state_dict names."""
    return {name.replace("/", "."): value for name, value in flat.items()}


def flax_paths_from_names(state):
    """The inverse of ``names_from_flax_paths``."""
    return {name.replace(".", "/"): value for name, value in state.items()}


def state_dict_from_jax(params):
    """``params``: the flax ``params`` collection as a nested dict of numpy
    (or array-like) values. Returns a state_dict of float32 tensors for
    ``model.load_state_dict`` (strict loading checks that every name
    matches)."""
    return {name: torch.from_numpy(np.array(value, dtype=np.float32))
            for name, value in flatten(params).items()}


def load_train_state(train_state, params, ema_params):
    """Loads a JAX ``TrainState``'s ``params`` and ``ema_params`` (nested
    dicts of numpy values) into the port's ``TrainState``: the model and
    its EMA copy. The optimizer state is not carried."""
    train_state.model.load_state_dict(state_dict_from_jax(params))
    train_state.ema_model.load_state_dict(state_dict_from_jax(ema_params))
    return train_state
