"""Data parallelism over ``torch.distributed`` (counterpart of
k_diffusion_tpu/parallel/__init__.py).

The JAX package puts one mesh over every device and lets ``shard_map``'s
``pmean`` reduce the gradients. Here each process is one rank holding a
whole copy of the model, the train step reduces its gradients itself with
``all_mean_`` (one coalesced all-reduce), and the draws that belong to the
global batch are made at its shape on every rank and cut with
``local_rows``, so that W ranks at batch b compute what one process
computes at batch W * b. The model is not wrapped in DDP: the step takes
its gradients with ``torch.autograd.grad``, which DDP's reducer never sees.

A process joins a group under ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N ...``), or when it is given an
address, its rank and the world size. Without either, every function here
sees one process and no collective runs. A collective that a backend lacks
raises; nothing falls back quietly.
"""

import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
_TORCHRUN = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def initialize_distributed(backend=None, **kwargs):
    """Joins the process group when torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``) or ``kwargs`` (``init_method``,
    ``world_size``, ``rank``, as ``torch.distributed.init_process_group``
    takes them) are present; a no-op otherwise, or when a group exists.
    ``backend`` defaults to NCCL where CUDA is present, else gloo; under
    NCCL the current CUDA device is first set to ``LOCAL_RANK``. Returns
    whether it created the group."""
    if dist.is_initialized() or not (
            kwargs or all(k in os.environ for k in _TORCHRUN)):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend=backend, **kwargs)
    return True


def process_index():
    """This process's rank (0 without a group). A function, so that tests
    can monkeypatch the rank gating without starting processes."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of processes (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process():
    """True on the process that owns the side effects: prints, demo grids,
    the metrics CSV, single-file checkpoints and the state pointer."""
    return process_index() == 0


def make_mesh(device_type=None):
    """A 1-D ``DeviceMesh`` over every rank, its axis named "data".
    ``device_type`` defaults to "cuda" under NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (process_count(),),
                            mesh_dim_names=(DATA_AXIS,))


def replicate(module):
    """Broadcasts ``module``'s parameters and buffers from rank 0 in place,
    so that every rank starts from rank 0's copy. Returns the module."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0)
    return module


def all_mean_(tensors):
    """In place: each tensor becomes its mean over the ranks (JAX's
    ``pmean``), the sum of one all-reduce over the tensors flattened
    together (one for each dtype and device) divided by the world size.
    Every rank ends with the same bits. Returns ``tensors``."""
    world = dist.get_world_size()
    kinds = {}
    for t in tensors:
        kinds.setdefault((t.dtype, t.device), []).append(t)
    for group in kinds.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
    return tensors


def all_gather_rows(t):
    """Every rank's ``t`` (the same shape on each) concatenated along dim 0
    in rank order, on every rank. Gloo gathers CPU tensors only, so a CUDA
    tensor goes through the host under gloo."""
    staged = t.cpu() if dist.get_backend() == "gloo" else t
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, staged.contiguous())
    return torch.cat(parts).to(t.device)


def local_rows(global_tensor, rank, world):
    """Rank ``rank``'s rows of a tensor drawn at the global batch: the
    ``rank``-th of ``world`` equal blocks along dim 0, the slice that
    JAX's ``shard_map`` hands each shard."""
    n, rem = divmod(global_tensor.shape[0], world)
    if rem or not 0 <= rank < world:
        raise ValueError(f"{global_tensor.shape[0]} rows do not split over "
                         f"{world} ranks for rank {rank}")
    return global_tensor[rank * n:(rank + 1) * n]
