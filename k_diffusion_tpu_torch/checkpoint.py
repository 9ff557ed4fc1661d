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

A sharded training checkpoint (``--checkpoint-format orbax``, named
``{name}_{step:08}.orbax`` as the JAX package names its Orbax directories)
holds the same state in ``torch.distributed.checkpoint``'s format, not
Orbax's: a directory that every rank writes its share of, in the
background (``dcp.async_save``, one save in flight), and beside it
``{path}_host.pt``, which rank 0 writes with ``torch.save``: the host dict,
the step and the non-tensor parts of the optimizer's state, each tensor
replaced by its name in the directory. ``write_state_json_after_commit``
moves the pointer only once the save has committed.

An inference checkpoint is a model's weights and its config in one
safetensors file.

Tensor names are the JAX package's ``/``-joined flax paths
(``down_0_layer_0/self_attn/qkv_proj/kernel``) and the config is JSON in the
metadata under ``config``, so a file either package writes loads into the
other. The files are read and written by ``utils.io``: the port needs no
safetensors package.
"""

import atexit
import json
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from . import convert, parallel
from .utils import io

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def _payload(state, host):
    return {"model": state.model.state_dict(),
            "model_ema": state.ema_model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "host": host}


def _restore(state, payload):
    state.model.load_state_dict(payload["model"])
    state.ema_model.load_state_dict(payload["model_ema"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state, payload["host"]


def save_checkpoint(path, state, host):
    """Writes the train state (``training.TrainState``) and the trainer's
    ``host`` dict (JSON-like values) to ``path``. Returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_payload(state, host), path)
    return path


def load_checkpoint(path, state):
    """Loads a ``save_checkpoint`` file, or a ``save_checkpoint_sharded``
    directory, into ``state`` (its model, EMA copy and optimizer, on their
    own devices) and returns (state, host)."""
    if Path(path).is_dir():
        return load_checkpoint_sharded(path, state)
    return _restore(state, torch.load(path, map_location="cpu",
                                      weights_only=True))


# a tensor's place in a sharded checkpoint's skeleton: {_TENSOR: its name}
_TENSOR = "__tensor__"
# the async save in flight, the state pointer that waits for it to commit,
# and the gloo group the saves coordinate over
_in_flight = None
_pending_state_json = None
_group = None


def _split(tree, name, tensors):
    """``tree`` with each tensor replaced by {_TENSOR: its name}; the
    tensors go into ``tensors`` under their names."""
    if isinstance(tree, torch.Tensor):
        tensors[name] = tree.detach()
        return {_TENSOR: name}
    if isinstance(tree, dict):
        return {k: _split(v, f"{name}/{k}", tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, f"{name}/{i}", tensors)
                          for i, v in enumerate(tree))
    return tree


def _join(tree, tensors):
    """The inverse of ``_split``."""
    if isinstance(tree, dict):
        if set(tree) == {_TENSOR}:
            return tensors[tree[_TENSOR]]
        return {k: _join(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_join(v, tensors) for v in tree)
    return tree


def _dcp_args(path):
    """``torch.distributed.checkpoint``'s arguments: no process group
    without one, else a gloo group of the checkpoints' own (made once, by
    every rank), so that a background save's collectives never run on the
    group that the training step all-reduces over at the same time."""
    global _group
    if not dist.is_initialized():
        return {"checkpoint_id": str(path), "no_dist": True}
    if _group is None:
        _group = dist.new_group(backend="gloo")
    return {"checkpoint_id": str(path), "process_group": _group}


def save_checkpoint_sharded(path, state, host, async_save=True):
    """Writes the train state and ``host`` as a sharded checkpoint: the
    tensors into the directory ``path`` through
    ``torch.distributed.checkpoint`` (each rank writes its share), the
    rest to ``{path}_host.pt`` from rank 0. Every rank calls it. With
    ``async_save`` it returns once the tensors are copied to the host and
    writes them in the background; it first waits for the save before it
    (one in flight), and ``wait_for_checkpoints`` (also run at exit) waits
    for this one. Returns the path."""
    global _in_flight
    import torch.distributed.checkpoint as dcp
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tensors = {}
    skeleton = _split(_payload(state, host), "", tensors)
    wait_for_checkpoints()
    if parallel.is_main_process():
        torch.save(skeleton, f"{path}_host.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if async_save:
            _in_flight = dcp.async_save(tensors, **_dcp_args(path))
            atexit.unregister(wait_for_checkpoints)  # registered once
            atexit.register(wait_for_checkpoints)
        else:
            dcp.save(tensors, **_dcp_args(path))
    return path


def load_checkpoint_sharded(path, state):
    """Loads a ``save_checkpoint_sharded`` checkpoint into ``state`` and
    returns (state, host). Every rank calls it; the tensors are read to
    the host, then copied to the model's and the optimizer's devices as
    ``load_checkpoint`` copies them."""
    import torch.distributed.checkpoint as dcp
    path = Path(path).absolute()
    skeleton = torch.load(f"{path}_host.pt", weights_only=True)
    metadata = dcp.FileSystemReader(str(path)).read_metadata()
    tensors = {name: torch.empty(meta.size, dtype=meta.properties.dtype)
               for name, meta in metadata.state_dict_metadata.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(tensors, **_dcp_args(path))
    return _restore(state, _join(skeleton, tensors))


def wait_for_checkpoints():
    """Waits until the save in flight, if any, has committed, then moves
    the state pointer that waited for it."""
    global _in_flight
    if _in_flight is not None:
        future, _in_flight = _in_flight, None
        # a Future, or an AsyncSaveResponse whose upload_completion is one
        getattr(future, "upload_completion", future).result()
    _flush_pending_state_json()



def write_state_json(name, ckpt_path):
    """Points ``{name}_state.json`` at ``ckpt_path``."""
    state_path = Path(f"{name}_state.json")
    state_path.write_text(json.dumps({"latest_checkpoint": str(ckpt_path)}))
    return state_path


def _flush_pending_state_json():
    global _pending_state_json
    if _pending_state_json is not None:
        pending, _pending_state_json = _pending_state_json, None
        write_state_json(*pending)


def write_state_json_after_commit(name, ckpt_path):
    """Points ``{name}_state.json`` at ``ckpt_path`` once the save in
    flight has committed: at the next save's wait, ``wait_for_checkpoints``
    or exit. Until then the pointer keeps naming the last checkpoint that
    is whole, so that a process that dies mid-save still resumes."""
    global _pending_state_json
    _pending_state_json = (str(name), str(ckpt_path))


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
