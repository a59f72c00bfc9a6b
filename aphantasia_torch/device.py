"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: asking for (or defaulting to) CUDA on a host
without a GPU raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda.  Raises when CUDA is asked for and is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    return dev
