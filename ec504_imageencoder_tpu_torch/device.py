"""Device selection: the entry points run on "cuda" unless the caller asks
for the CPU, and never fall back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` ("cpu", "cuda", "cuda:1" or a torch.device) -> torch.device.

    Raises when CUDA is requested but absent: a CUDA encode never turns
    into a CPU encode behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cpu' or 'cuda[:n]', got {str(dev)!r}")
    return dev
