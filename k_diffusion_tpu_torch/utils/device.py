"""Where the port's entry points put their tensors when the caller names no
device (on the card), and the dtype they compute in there (bfloat16 by
default; float32 on request, every kernel having a float32 form)."""

import os

import torch


def default_device(device=None):
    """``device`` as a ``torch.device`` when it is given, else the card of
    this rank under torchrun (``cuda:LOCAL_RANK``) or the current CUDA
    device. Raises when no device is given and CUDA is absent: the port
    runs on the card unless the caller asks for the CPU, and never falls
    back to it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


# the compute dtypes of the card's kernels: every kernel takes bfloat16 and
# has a float32 form (TF32 tensor cores), so every model family takes both
CARD_DTYPES = (torch.bfloat16, torch.float32)


def compute_dtype(device, dtype=None, card_dtypes=CARD_DTYPES,
                  lacking=None):
    """The compute dtype of a model on ``device``: ``dtype`` when it is
    given, else bfloat16 on a CUDA device and float32 on any other. On a
    CUDA device a model computes only in a dtype its kernels take,
    ``card_dtypes`` (its family's); another explicit dtype raises
    ValueError there, before any parameter is allocated, naming
    ``lacking``, the model's kernels that have no float32 form yet."""
    cuda = torch.device(device).type == "cuda"
    if dtype is None:
        return torch.bfloat16 if cuda else torch.float32
    if cuda and dtype not in card_dtypes:
        if dtype in CARD_DTYPES:
            raise ValueError(
                f"compute dtype {dtype} on {device}: {lacking} compute in "
                "bfloat16 only on the card; pass dtype=torch.bfloat16 or "
                "None")
        raise ValueError(
            f"compute dtype {dtype} on {device}: the port's kernels compute "
            "in bfloat16 or float32 on the card; pass dtype=torch.bfloat16, "
            "torch.float32 or None")
    return dtype
