"""Inference checkpoints: a model's weights and its config in one
safetensors file (counterpart of ``save_inference`` and ``load_inference``
in k_diffusion_tpu/checkpoint.py).

Tensor names are the JAX package's ``/``-joined flax paths
(``down_0_layer_0/self_attn/qkv_proj/kernel``) and the config is JSON in the
metadata under ``config``, so a file either package writes loads into the
other. The files are read and written by ``utils.io``: the port needs no
safetensors package. The msgpack training checkpoint is not ported yet.
"""

import json
from pathlib import Path

import torch

from . import convert
from .utils import io

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


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
