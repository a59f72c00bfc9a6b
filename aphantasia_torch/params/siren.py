"""SIREN generator (counterpart of aphantasia_tpu.params.siren): a
sine-activated coordinate MLP (Sitzmann et al. 2020):

  layer 0:   sin(w0_first * (W x + b)),  W ~ U(-1/in, 1/in)
  hidden l:  sin(w0 * (W x + b)),        W ~ U(-sqrt(6/in)/w0, +...)
  output:    sigmoid(W x + b)

with biases U(-1/sqrt(in), 1/sqrt(in)).  The params are the CPPN's flat
list [w0, b0, w1, b1, ...] and the snapshots its `.npy` layout; w0 is not
stored (pass --w0 / --w0_first when resuming).  The decode is the CPPN's
chain of float32 products over the coordinate grid.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aphantasia_torch.params.cppn import coord_decode, export_npy, read_npy


@dataclasses.dataclass(frozen=True)
class SIRENParameterizer:
    """(nf_in = 2 coordinates) -> num_layers sine layers of nf -> 3,
    sigmoid."""
    size: tuple                  # (H, W)
    nf: int = 256
    num_layers: int = 5
    w0: float = 30.0
    w0_first: float = 30.0
    nf_in: int = 2
    nf_out: int = 3

    @property
    def layer_dims(self):
        dims = [(self.nf_in, self.nf)]
        for _ in range(self.num_layers - 1):
            dims.append((self.nf, self.nf))
        dims.append((self.nf, self.nf_out))
        return dims

    def _omega(self, i: int) -> float:
        return self.w0_first if i == 0 else self.w0

    def init(self, generator: torch.Generator) -> list:
        dev = generator.device
        dims = self.layer_dims
        params = []
        for i, (cin, cout) in enumerate(dims):
            if i == 0:
                bound = 1.0 / cin
            elif i == len(dims) - 1:
                bound = float(np.sqrt(6.0 / cin)) / self.w0
            else:
                bound = float(np.sqrt(6.0 / cin)) / self._omega(i)
            bb = 1.0 / float(np.sqrt(cin))
            params.append((2.0 * torch.rand((cin, cout), generator=generator,
                                            device=dev) - 1.0) * bound)
            params.append((2.0 * torch.rand((cout,), generator=generator,
                                            device=dev) - 1.0) * bb)
        return params

    def decode(self, params, shift=None, contrast: float = 1.0):
        """[1,3,H,W] in (0,1); `shift` and `contrast` are accepted and
        ignored, as the CPPN's."""
        del shift, contrast
        return coord_decode(params, self.size, self.nf_out,
                            lambda i, x: torch.sin(self._omega(i) * x))

    def image(self, params, shift=None, contrast: float = 1.0):
        return self.decode(params, shift, contrast)


def load_npy(path: str, device="cpu"):
    """A SIREN snapshot -> (params, nf, num_layers); w0 lives on the
    parameterizer."""
    params = read_npy(path, device)
    return params, params[0].shape[-1], len(params) // 2 - 1


def to_shader_layers(params, w0: float = 30.0, w0_first: float = 30.0):
    """The params -> the shader exporter's layer dicts, each layer's
    frequency folded into its weights and bias (sin(w0 (W x + b)) =
    sin((w0 W) x + w0 b)), so the shader emits a plain sin(); the head is
    labelled 'sigmoid'."""
    n = len(params) // 2
    layers = []
    for i in range(n):
        w = params[2 * i].detach().cpu().numpy().astype(np.float32)
        b = params[2 * i + 1].detach().cpu().numpy().astype(np.float32)
        if i < n - 1:
            om = np.float32(w0_first if i == 0 else w0)
            w, b = w * om, b * om
        layers.append({"weights": w[None, None], "bias": b,
                       "activation": "sine" if i < n - 1 else "sigmoid"})
    return layers


__all__ = ["SIRENParameterizer", "export_npy", "load_npy", "to_shader_layers"]
