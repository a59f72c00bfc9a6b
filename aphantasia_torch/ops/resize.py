"""Bicubic tap weights matching torch `F.interpolate(mode='bicubic',
align_corners=True)` (counterpart of aphantasia_tpu.ops.resize): cubic
convolution A=-0.75, taps clamped at the borders."""
from __future__ import annotations

import torch

_A = -0.75


def _cc1(x):
    return ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1.0


def _cc2(x):
    return ((_A * x - 5.0 * _A) * x + 8.0 * _A) * x - 4.0 * _A


def cubic_tap_weights(t: torch.Tensor) -> torch.Tensor:
    """Weights of the taps [floor-1, floor, floor+1, floor+2] at fractional
    offset t in [0,1): shape t.shape + (4,)."""
    return torch.stack([_cc2(t + 1.0), _cc1(t), _cc1(1.0 - t), _cc2(2.0 - t)],
                       dim=-1)


def resize_axis_taps(out_size: int, in_size, offset=0):
    """Tap indices and weights for one axis, align_corners=True:
    src = i * (in_size - 1) / (out_size - 1), taps clamped to
    [0, in_size-1], then shifted by `offset`.  `in_size`/`offset` may be
    [S] tensors (per-sample crops).

    Returns (idx int32 [..., out_size, 4], w float32 [..., out_size, 4])."""
    in_size = torch.as_tensor(in_size, dtype=torch.float32)
    offset = torch.as_tensor(offset, device=in_size.device)
    i = torch.arange(out_size, dtype=torch.float32, device=in_size.device)
    step = (in_size - 1.0) / max(out_size - 1, 1)
    src = i * step[..., None]
    y0 = torch.floor(src)
    w = cubic_tap_weights(src - y0)
    taps = y0[..., None] + torch.arange(-1, 3, dtype=torch.float32,
                                        device=in_size.device)
    hi = (in_size - 1.0)[..., None, None]
    taps = torch.minimum(torch.clamp(taps, min=0.0), hi)
    idx = taps.to(torch.int32) + offset.to(torch.int32)[..., None, None]
    return idx, w
