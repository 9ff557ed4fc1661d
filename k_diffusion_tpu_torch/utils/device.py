"""Where the port's entry points put their tensors when the caller names no
device: on the card."""

import torch


def default_device(device=None):
    """``device`` as a ``torch.device`` when it is given, else the current
    CUDA device. Raises when no device is given and CUDA is absent: the
    port runs on the card unless the caller asks for the CPU, and never
    falls back to it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
