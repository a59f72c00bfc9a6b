"""`.pt` snapshots (counterpart of aphantasia_tpu.io.checkpoint), written
and read with torch itself.  clip_fft saves a params *list*, as the
reference does; the JAX package's torch-free codec reads these files."""
from __future__ import annotations

import os

import numpy as np
import torch


def save_pt(path: str, obj) -> None:
    """Save a tensor/array or a list of them as CPU tensors.  The file
    appears under its name only when it is whole (written aside, then
    renamed): a fleet's rank 0 reads the snapshots that other hosts write
    once it sees their names."""
    def cpu(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).detach().cpu()
    part = f"{path}.{os.getpid()}.part"
    torch.save([cpu(x) for x in obj] if isinstance(obj, (list, tuple))
               else cpu(obj), part)
    os.replace(part, path)


def load_pt(path: str):
    """Load a snapshot (tensors only, no arbitrary pickles) as numpy."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, (list, tuple)):
        return [o.numpy() for o in obj]
    return obj.numpy()
