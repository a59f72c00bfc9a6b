"""Conversions from the JAX package's state (given as numpy arrays) to the
port's tensors: the CLIP parameter tree of `clip_init`, FFT spectrum and
DWT pyramid params, the aesthetic head, the LPIPS weights and optax
Adam/AMSGrad states.  The only place where layouts change: the port keeps
the JAX layouts (linear weights [in, out], merged qkv, [1,3,H,W//2+1,2]
spectra, the pyramid list), so those conversions are device/dtype moves of
the same arrays; the LPIPS convolutions alone change, from the JAX HWIO
to torch's OIHW.
"""
from __future__ import annotations

import numpy as np
import torch

from aphantasia_torch.ops.optim import OptState


def _tensor(a, device):
    """A C-contiguous copy of `a` as a tensor (a transposed view would
    otherwise keep its strides)."""
    return torch.as_tensor(np.array(a, order="C"), device=device)


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


def dwt_params_from_numpy(params, device="cpu"):
    """The DWT pyramid [Yl, Yh_1, ..., Yh_J] (same layout on both sides)."""
    return [_tensor(p, device).float().contiguous() for p in params]


def aesthetic_params_from_numpy(params, device="cpu"):
    """The aesthetic head {"w" [nf,1], "b" [1]} (same layout)."""
    return {k: _tensor(v, device).float() for k, v in params.items()}


def lpips_params_from_numpy(params, device="cpu"):
    """The JAX LPIPS tree (convolutions HWIO) -> the port's (OIHW)."""
    return {"convs": [{"w": _tensor(np.asarray(c["w"]).transpose(3, 2, 0, 1),
                                    device).float().contiguous(),
                       "b": _tensor(c["b"], device).float()}
                      for c in params["convs"]],
            "lins": [_tensor(w, device).float() for w in params["lins"]]}


def _moment(m, device):
    """A moment of the state: one array, or a list for list params."""
    if isinstance(m, (list, tuple)):
        return [_tensor(x, device).float() for x in m]
    return _tensor(m, device).float()


def opt_state_from_optax(state, device="cpu") -> OptState:
    """An optax state of `adam`/`adamw` (ScaleByAdamState in a chain) or of
    the `adamw_custom` chain (ScaleByAmsgradState) -> OptState; the moments
    of list params stay lists."""
    leaves = state if isinstance(state, (tuple, list)) else (state,)
    for s in leaves:
        if hasattr(s, "nu") and hasattr(s, "count"):
            nu_max = getattr(s, "nu_max", None)
            return OptState(
                count=torch.as_tensor(np.array(s.count), dtype=torch.int32,
                                      device=device),
                mu=_moment(s.mu, device), nu=_moment(s.nu, device),
                nu_max=None if nu_max is None else _moment(nu_max, device))
        if isinstance(s, (tuple, list)):
            try:
                return opt_state_from_optax(s, device)
            except ValueError:
                continue
    raise ValueError("no Adam/AMSGrad state found in the optax state")
