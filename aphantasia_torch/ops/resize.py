"""Cubic resampling (counterpart of aphantasia_tpu.ops.resize): the
cutouts' bicubic tap weights, matching torch `F.interpolate(mode='bicubic',
align_corners=True)` (cubic convolution A=-0.75, taps clamped at the
borders), and the upsampling of `jax.image.resize(..., "cubic")` that the
`elastic` pipeline's displacement tracks use (Keys A=-0.5 on half-pixel
centres, out-of-range taps dropped and the rest renormalised), and the
full-frame bicubic resize of `--sync` (`resize_bicubic`)."""
from __future__ import annotations

import functools

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
    # a true division on every device: CUDA divides a tensor by a Python
    # scalar as a multiply by its reciprocal, an ulp off the CPU's (and
    # JAX's) quotient for most sizes, and the `--pallas` cut rounds these
    # weights to bf16, where an ulp can flip a rounding
    step = (in_size - 1.0) / torch.full_like(in_size,
                                             float(max(out_size - 1, 1)))
    src = i * step[..., None]
    y0 = torch.floor(src)
    w = cubic_tap_weights(src - y0)
    taps = y0[..., None] + torch.arange(-1, 3, dtype=torch.float32,
                                        device=in_size.device)
    hi = (in_size - 1.0)[..., None, None]
    taps = torch.minimum(torch.clamp(taps, min=0.0), hi)
    idx = taps.to(torch.int32) + offset.to(torch.int32)[..., None, None]
    return idx, w


def _keys_cubic(x):
    """Keys' cubic convolution kernel, A = -0.5, at |offset| x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, far, near))


def cubic_resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """The [n_in, n_out] float32 weights of `jax.image.resize(x, ...,
    "cubic")` along one axis when upsampling (n_out >= n_in): Keys A = -0.5
    on half-pixel centres, src = (j + 0.5) * n_in / n_out - 0.5, with the
    taps that fall outside [0, n_in) dropped and the rest renormalised to
    sum to 1.  (Not the `align_corners=True`, A = -0.75 cubic above.)"""
    if n_out < n_in:
        raise ValueError("cubic_resize_matrix upsamples only "
                         f"({n_in} -> {n_out}); downsampling antialiases")
    inv_scale = 1.0 / (n_out / n_in)
    src = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
           * inv_scale - 0.5)
    i = torch.arange(n_in, dtype=torch.float32, device=device)
    wts = _keys_cubic(torch.abs(src[None, :] - i[:, None]))
    total = wts.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (src >= -0.5) & (src <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def resize_cubic_last(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """`jax.image.resize(x, x.shape[:-1] + (n_out,), "cubic")` for a
    float32 x, upsampling its last axis (what the `elastic` pipeline's
    smooth tracks need: [S, 9] -> [S, n])."""
    m = cubic_resize_matrix(x.shape[-1], n_out, device=x.device)
    return torch.matmul(x.float(), m)


@functools.lru_cache(maxsize=16)
def _bicubic_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """The dense [out_size, in_size] float32 matrix of `resize_axis_taps`
    (the taps' weights scattered into their columns, clamped duplicates
    summed), built once per size and device: a host table built at every
    call would be a pageable copy, which a CUDA graph's capture refuses.
    Shared: never written to."""
    idx, w = resize_axis_taps(out_size, in_size)
    rows = torch.arange(out_size)[:, None].expand_as(idx)
    mat = torch.zeros((out_size, in_size), dtype=w.dtype)
    mat.index_put_((rows, idx.long()), w, accumulate=True)
    return mat.to(device)


def resize_bicubic(img: torch.Tensor, size) -> torch.Tensor:
    """Full-frame bicubic resize of [..., H, W] to `size`, align_corners=True
    (`F.interpolate(img, size, mode='bicubic', align_corners=True)`, taps
    clamped at the borders), as two dense interpolation-matrix products."""
    h, w = img.shape[-2:]
    oh, ow = size
    wy = _bicubic_matrix(int(oh), int(h), img.device)
    wx = _bicubic_matrix(int(ow), int(w), img.device)
    return torch.matmul(torch.matmul(wy, img), wx.t())
