"""Conversions from the JAX package's state (given as numpy arrays) to the
port's tensors: the CLIP parameter tree of `clip_init`, FFT spectrum
params, and optax Adam/AMSGrad states.  The only place where layouts would
change: the port keeps the JAX layouts (linear weights [in, out], merged
qkv, [1,3,H,W//2+1,2] spectra), so every conversion is a device/dtype move
of the same arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from aphantasia_torch.ops.optim import OptState


def _tensor(a, device):
    return torch.as_tensor(np.array(a), device=device)


def clip_params_from_numpy(tree, device="cpu"):
    """The JAX `clip_init` tree (nested dicts/lists of arrays, e.g. after
    `jax.tree.map(np.asarray, params)`) -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: clip_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clip_params_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)


def fft_params_from_numpy(params, device="cpu"):
    """[1,3,H,W//2+1,2] real/imag spectrum (same layout on both sides)."""
    return _tensor(params, device).float().contiguous()


def opt_state_from_optax(state, device="cpu") -> OptState:
    """An optax state of `adam`/`adamw` (ScaleByAdamState in a chain) or of
    the `adamw_custom` chain (ScaleByAmsgradState) -> OptState."""
    leaves = state if isinstance(state, (tuple, list)) else (state,)
    for s in leaves:
        if hasattr(s, "nu") and hasattr(s, "count"):
            nu_max = getattr(s, "nu_max", None)
            return OptState(
                count=int(np.asarray(s.count)),
                mu=_tensor(s.mu, device).float(),
                nu=_tensor(s.nu, device).float(),
                nu_max=(None if nu_max is None
                        else _tensor(nu_max, device).float()))
        if isinstance(s, (tuple, list)):
            try:
                return opt_state_from_optax(s, device)
            except ValueError:
                continue
    raise ValueError("no Adam/AMSGrad state found in the optax state")
