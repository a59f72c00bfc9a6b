"""Conversions from the JAX package's state (given as numpy arrays) to the
port's tensors: the CLIP parameter tree of `clip_init`, FFT spectrum and
DWT pyramid params, the CPPN and SIREN layers, the aesthetic head, the
LPIPS weights, the VQGAN decoder of `vqgan_init` / `convert_taming`, optax
Adam/AMSGrad states and the Depth-Anything-V2 tree of `dav2_init`, and a
rank's shard of a sharded canvas (`spatial_shard_from_numpy`).  The
only place where layouts change: the port keeps the JAX layouts (linear
weights [in, out], merged qkv, [1,3,H,W//2+1,2] spectra, the pyramid
list), so those conversions are device/dtype moves of the same arrays;
the convolutions alone change, from the JAX HWIO to torch's OIHW (and
DA-V2's two transposed convolutions to torch's [in, out, kh, kw]), and the
coordinate nets' list of {"w", "b"} layers becomes the flat list [w0, b0,
w1, b1, ...], read by key.
"""
from __future__ import annotations

import numpy as np
import torch

from aphantasia_torch.ops.optim import OptState


def _tensor(a, device):
    """A C-contiguous copy of `a` as a tensor (a transposed view would
    otherwise keep its strides)."""
    return torch.as_tensor(np.array(a, order="C"), device=device)


def hwio_to_oihw(w):
    """A JAX convolution weight [kh, kw, in, out] -> torch's [out, in, kh,
    kw]."""
    return np.asarray(w).transpose(3, 2, 0, 1)


def clip_params_from_numpy(tree, device="cpu"):
    """The JAX `clip_init` tree (nested dicts/lists of arrays, e.g. after
    `jax.tree.map(np.asarray, params)`) -> the same tree of tensors, the
    ResNet convolutions (the 4-D leaves) from HWIO to OIHW."""
    if isinstance(tree, dict):
        return {k: clip_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clip_params_from_numpy(v, device) for v in tree]
    if np.ndim(tree) == 4:
        return _tensor(hwio_to_oihw(tree), device)
    return _tensor(tree, device)


def fft_params_from_numpy(params, device="cpu"):
    """[1,3,H,W//2+1,2] real/imag spectrum (same layout on both sides)."""
    return _tensor(params, device).float().contiguous()


def dwt_params_from_numpy(params, device="cpu"):
    """The DWT pyramid [Yl, Yh_1, ..., Yh_J] (same layout on both sides)."""
    return [_tensor(p, device).float().contiguous() for p in params]


def coord_params_from_numpy(layers, device="cpu"):
    """The CPPN / SIREN layers, a list of {"w" [in,out], "b" [out]} (the
    JAX tree, whose flattening puts "b" before "w"), -> the port's flat
    list [w0, b0, w1, b1, ...], read by key."""
    return [_tensor(layer[k], device).float()
            for layer in layers for k in ("w", "b")]


def vqgan_params_from_numpy(tree, device="cpu"):
    """The JAX VQGAN decoder tree (`vqgan_init`, `convert_taming`) -> the
    port's: the same nested dicts and lists, float32, the convolutions
    (the 4-D leaves) from HWIO to OIHW."""
    if isinstance(tree, dict):
        return {k: vqgan_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [vqgan_params_from_numpy(v, device) for v in tree]
    if np.ndim(tree) == 4:
        return _tensor(hwio_to_oihw(tree), device).float()
    return _tensor(tree, device).float()


def aesthetic_params_from_numpy(params, device="cpu"):
    """The aesthetic head {"w" [nf,1], "b" [1]} (same layout)."""
    return {k: _tensor(v, device).float() for k, v in params.items()}


def lpips_params_from_numpy(params, device="cpu"):
    """The JAX LPIPS tree (convolutions HWIO) -> the port's (OIHW)."""
    return {"convs": [{"w": _tensor(hwio_to_oihw(c["w"]),
                                    device).float().contiguous(),
                       "b": _tensor(c["b"], device).float()}
                      for c in params["convs"]],
            "lins": [_tensor(w, device).float() for w in params["lins"]]}


def dav2_params_from_numpy(tree, device="cpu"):
    """The JAX `dav2_init` / `convert_hf_dav2` tree -> the port's: the
    convolutions (4-D leaves) from HWIO to OIHW, the transposed ones
    (`up4_w`, `up2_w`) to [in, out, kh, kw]."""
    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, key) for v in t]
        if key in ("up4_w", "up2_w"):
            return _tensor(np.asarray(t).transpose(2, 3, 0, 1),
                           device).float()
        if np.ndim(t) == 4:
            return _tensor(hwio_to_oihw(t), device).float()
        return _tensor(t, device).float()
    return walk(tree)


def _moment(m, device):
    """A moment of the state: one array, a list for list params, or the
    coordinate nets' list of {"w", "b"} layers (flattened by key)."""
    if isinstance(m, (list, tuple)) and m and isinstance(m[0], dict):
        return coord_params_from_numpy(m, device)
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


def spatial_shard_from_numpy(spar, params, opt_state=None, device="cpu"):
    """A rank's part of canonical (unpadded) params in the JAX layout (a
    spectrum, RGB pixels or the DWT pyramid, as numpy) and of an optax
    state over them, for the sharded canvas `spar`
    (parallel/spatial.py, parallel/spatial_dwt.py), padded as
    `spar.shard` pads: (params, OptState or None)."""
    def shard(tree):
        if isinstance(tree, (list, tuple)):
            return spar.shard([_tensor(p, device).float() for p in tree])
        return spar.shard(_tensor(tree, device).float())
    state = None
    if opt_state is not None:
        full = opt_state_from_optax(opt_state, device)
        state = OptState(full.count, shard(full.mu), shard(full.nu),
                         None if full.nu_max is None else shard(full.nu_max))
    return shard(params), state
