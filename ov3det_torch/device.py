"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means CUDA.

    Raises when CUDA is asked for, or defaulted to, and no card is present:
    the entry points never carry on on the CPU unless the caller asks.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
