"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``cuda``) as a :class:`torch.device`, with a
    CUDA device's index filled in (``cuda`` -> ``cuda:<current>``) so that
    it compares equal to a tensor's device.

    A CUDA device on a host without CUDA raises: the entry points never
    carry on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
