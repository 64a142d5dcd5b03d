"""Which device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when the caller names none. The port's kernels
    run only on an NVIDIA card, so without one this raises instead of
    running the plain versions unasked; `device="cpu"` asks for those."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: the port runs its kernels on the card; "
            'pass device="cpu" to run the plain PyTorch versions instead')
    return torch.device("cuda")
