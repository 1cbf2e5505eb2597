"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``); only an explicit ``"cpu"``
    gives the CPU.  Raises when a CUDA device is asked for and there is
    none — an entry point never drops to the CPU on its own."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly")
    return dev
