"""Training and inference checkpoints (counterpart of
k_diffusion_tpu/checkpoint.py).

A training checkpoint is one ``torch.save`` file: the model, its EMA copy,
``GroupedOptimizer``'s state (AdamW's or 8-bit AdamW's moments and their
step counts, or SGD's momentum), the
step and the trainer's host dict (epoch, step, ``batch_in_epoch``,
elapsed seconds, the loss EMA, the EMA schedule's state, the GNS state and
the config). Files are named as the JAX package names them,
``{name}_{step:08}.ckpt``, and ``{name}_state.json`` points to the latest.
The JAX package's msgpack training checkpoints are not read: optax's state
is its own layout. Weights cross between the packages through inference
checkpoints.

An inference checkpoint is a model's weights and its config in one
safetensors file.

Tensor names are the JAX package's ``/``-joined flax paths
(``down_0_layer_0/self_attn/qkv_proj/kernel``) and the config is JSON in the
metadata under ``config``, so a file either package writes loads into the
other. The files are read and written by ``utils.io``: the port needs no
safetensors package.
"""

import json
from pathlib import Path

import torch

from . import convert
from .utils import io

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def save_checkpoint(path, state, host):
    """Writes the train state (``training.TrainState``) and the trainer's
    ``host`` dict (JSON-like values) to ``path``. Returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "model_ema": state.ema_model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "host": host}, path)
    return path


def load_checkpoint(path, state):
    """Loads a ``save_checkpoint`` file into ``state`` (its model, EMA copy
    and optimizer, on their own devices) and returns (state, host)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.ema_model.load_state_dict(payload["model_ema"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state, payload["host"]


def write_state_json(name, ckpt_path):
    """Points ``{name}_state.json`` at ``ckpt_path``."""
    state_path = Path(f"{name}_state.json")
    state_path.write_text(json.dumps({"latest_checkpoint": str(ckpt_path)}))
    return state_path


def latest_checkpoint(name):
    """The checkpoint ``{name}_state.json`` points to, or None."""
    state_path = Path(f"{name}_state.json")
    if not state_path.exists():
        return None
    return json.loads(state_path.read_text())["latest_checkpoint"]


def save_inference(path, model_or_state_dict, config, dtype=None):
    """Writes a model's (or a state_dict's) tensors, cast to ``dtype``
    (a torch dtype or "float32", "float16", "bfloat16"; default: as they
    are), with ``config`` in the metadata. Returns the path."""
    state = (model_or_state_dict.state_dict()
             if isinstance(model_or_state_dict, torch.nn.Module)
             else model_or_state_dict)
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    tensors = {name: t.detach().to("cpu", dtype) if dtype else t.detach()
               for name, t in convert.flax_paths_from_names(state).items()}
    return io.save_file(tensors, path, metadata={"config": json.dumps(config)})


def load_inference(path):
    """Returns (state_dict, config) from an inference checkpoint: CPU
    tensors in the file's dtype under the port's names (for
    ``model.load_state_dict``, which casts them to the parameters' dtype),
    and the config dict, or None where the file has none."""
    tensors, metadata = io.load_file(Path(path))
    config = json.loads(metadata["config"]) if "config" in metadata else None
    return convert.names_from_flax_paths(tensors), config
