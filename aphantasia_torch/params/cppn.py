"""CPPN generator (counterpart of aphantasia_tpu.params.cppn): a 1x1-conv
MLP over an xy coordinate grid.

atan-based channel-doubling activations ('comp' / 'unbias') or a
normalised relu, a sigmoid output, weights normal(0, sqrt(1/nf_in)) and
biases uniform(-0.5, 0.5), and the reference `.npy` snapshot layout
([w (1,1,in,out), b (out), ...] as an object array), which both packages
read and write.

The params are a flat list of float32 tensors in the snapshot's own order,
[w0 [in,out], b0 [out], w1, b1, ...], so the optimizer, the step loops and
the snapshots all walk one list.  The JAX package keeps a list of
{"w", "b"} dicts, which `jax.tree_util` flattens with "b" before "w":
`convert.coord_params_from_numpy` maps that tree (and optax's moments) by
key, never by leaf order.

The decode is a chain of [H*W, nf] float32 products over the coordinate
grid (plain `torch.matmul`, as the JAX package computes them outside any
Pallas kernel); the grid is built once per size and device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def get_mgrid(side_x: int, side_y: int) -> np.ndarray:
    """The reference's [1,2,W,H] coordinate grid in [-1,1] (its meshgrid
    of (ys, xs)), float32."""
    ys = np.linspace(-1, 1, num=side_y)
    xs = np.linspace(-1, 1, num=side_x)
    mgrid = np.stack(np.meshgrid(ys, xs), axis=-1)
    mgrid = np.transpose(mgrid, (2, 0, 1))[np.newaxis]
    return mgrid.astype(np.float32)


@functools.lru_cache(maxsize=8)
def coord_grid(h: int, w: int, device) -> torch.Tensor:
    """The decode's input, `get_mgrid(w, h)[0]` as [H*W, 2] rows, on
    `device`, built once (a captured step must not copy host tables).
    Shared: never written to."""
    return torch.as_tensor(get_mgrid(w, h)[0].reshape(2, -1).T.copy(),
                           device=device)


def act_comp(x):
    a = torch.atan(x)
    return torch.cat([a / 0.67, (a * a) / 0.6], dim=-1)


def act_unbias(x):
    a = torch.atan(x)
    return torch.cat([a / 0.67, (a * a - 0.45) / 0.396], dim=-1)


def act_relu(x):
    return (torch.relu(x) - 0.40) / 0.58


_ACTS = {"comp": act_comp, "unbias": act_unbias, "relu": act_relu}


def coord_decode(params, size, nf_out: int, act) -> torch.Tensor:
    """The coordinate MLP over the grid of `size` (H, W): layer i is
    x @ w_i + b_i, then `act(i, x)` for the hidden layers and a sigmoid
    for the last -> [1, nf_out, H, W]."""
    h, w = size
    x = coord_grid(h, w, params[0].device)
    n = len(params) // 2
    for i in range(n):
        x = x @ params[2 * i] + params[2 * i + 1]
        x = torch.sigmoid(x) if i == n - 1 else act(i, x)
    return x.T.reshape(1, nf_out, h, w)


@dataclasses.dataclass(frozen=True)
class CPPNParameterizer:
    """(nf_in = 2 coordinates) -> num_layers hidden layers of nf -> 3,
    sigmoid."""
    size: tuple                  # (H, W)
    nf: int = 24
    num_layers: int = 10
    act_fn: str = "unbias"
    nf_in: int = 2
    nf_out: int = 3

    @property
    def layer_dims(self):
        hid_in = self.nf if self.act_fn == "relu" else self.nf * 2
        dims = [(self.nf_in, self.nf)]
        for _ in range(self.num_layers - 1):
            dims.append((hid_in, self.nf))
        dims.append((hid_in, self.nf_out))
        return dims

    def init(self, generator: torch.Generator) -> list:
        dev = generator.device
        params = []
        for cin, cout in self.layer_dims:
            params.append(torch.randn((cin, cout), generator=generator,
                                      device=dev) * float(np.sqrt(1.0 / cin)))
            params.append(torch.rand((cout,), generator=generator,
                                     device=dev) - 0.5)
        return params

    def decode(self, params, shift=None, contrast: float = 1.0):
        """[1,3,H,W] in (0,1); `shift` and `contrast` are accepted as the
        FFT decode's are, and ignored (the sigmoid head needs neither)."""
        del shift, contrast
        act = _ACTS[self.act_fn]
        return coord_decode(params, self.size, self.nf_out,
                            lambda i, x: act(x))

    def image(self, params, shift=None, contrast: float = 1.0):
        return self.decode(params, shift, contrast)


def export_npy(params, path: str) -> None:
    """The reference's snapshot: an object array of float32 arrays, the
    weights as [1,1,in,out] and the biases as [out]."""
    arrays = []
    for i, p in enumerate(params):
        a = p.detach().cpu().numpy().astype(np.float32)
        arrays.append(a[None, None] if i % 2 == 0 else a)
    out = np.empty(len(arrays), object)
    out[:] = arrays
    np.save(path if path.endswith(".npy") else path + ".npy", out,
            allow_pickle=True)


def read_npy(path: str, device="cpu") -> list:
    """A snapshot's arrays as the flat params list on `device`."""
    arrays = np.load(path, allow_pickle=True)
    return [torch.as_tensor(np.array(a[0, 0] if i % 2 == 0 else a,
                                     np.float32), device=device)
            for i, a in enumerate(arrays)]


def load_npy(path: str, device="cpu"):
    """A snapshot -> (params, nf, num_layers, act_fn); relu when the
    first layer's width equals the second's input (no channel
    doubling), else unbias."""
    params = read_npy(path, device)
    nf = params[0].shape[-1]
    num_layers = len(params) // 2 - 1
    act_fn = "relu" if params[0].shape[-1] == params[2].shape[-2] else "unbias"
    return params, nf, num_layers, act_fn


def to_shader_layers(params, act_fn: str) -> list:
    """The params -> the layer dicts of the shader exporter."""
    return [{"weights": params[i].detach().cpu().numpy()
             .astype(np.float32)[None, None],
             "bias": params[i + 1].detach().cpu().numpy().astype(np.float32),
             "activation": act_fn} for i in range(0, len(params), 2)]
