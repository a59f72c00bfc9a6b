"""Bilinear sampling, the torchvision-style affine and the homography grid
(counterpart of aphantasia_tpu.ops.warp).

The core samples at pixel indices with four gathered taps, written out as
the JAX package writes it: reflection padding folds the coordinates into
the frame (align_corners=True), and zero padding drops each tap that falls
outside the frame on its own.  The normalized `grid_sample` wrapper maps
[-1, 1] coordinates as torch's align_corners conventions do.  These run
once a frame on the video path, outside the gradient.  The motion scalars
may be 0-d tensors on the image's device, so a captured frame reads them
at each replay and computes the affine's cos, sin and tan there.
"""
from __future__ import annotations

import math

import torch


def _f32(x, device) -> torch.Tensor:
    """`x` as a float32 tensor on `device` (a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _reflect(x, lo: float, hi: float):
    """Reflect coordinates into [lo, hi] (torch 'reflection',
    align_corners=True)."""
    rng = hi - lo
    x = torch.remainder(torch.abs(x - lo), 2 * rng)
    return hi - torch.abs(x - rng)


def sample_px(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
              padding: str = "zeros", fill: float = 0.0) -> torch.Tensor:
    """Bilinear sample of img [B,C,H,W] at pixel coordinates ix, iy
    [B,Ho,Wo]; padding 'zeros' (each tap outside the frame is `fill`),
    'border' or 'reflection'."""
    b, c, h, w = img.shape
    if padding == "reflection":
        ix = _reflect(ix, 0.0, w - 1.0)
        iy = _reflect(iy, 0.0, h - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    tx = ix - x0
    ty = iy - y0
    flat_img = img.reshape(b, c, h * w)

    def tap(yi, xi):
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        flat = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
        vals = torch.gather(flat_img, 2, flat).reshape(b, c, *xi.shape[1:])
        if padding == "zeros":
            inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            vals = torch.where(inb[:, None], vals,
                               torch.full((), fill, dtype=vals.dtype,
                                          device=vals.device))
        return vals

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    txe = tx[:, None]
    tye = ty[:, None]
    return (v00 * (1 - txe) * (1 - tye) + v01 * txe * (1 - tye)
            + v10 * (1 - txe) * tye + v11 * txe * tye)


def grid_sample(img: torch.Tensor, grid: torch.Tensor, padding: str = "zeros",
                align_corners: bool = True, fill: float = 0.0) -> torch.Tensor:
    """`F.grid_sample` (bilinear) written on `sample_px`: img [C,H,W] or
    [B,C,H,W], grid [Ho,Wo,2] or [B,Ho,Wo,2] with xy in [-1, 1]."""
    batched = img.ndim == 4
    if not batched:
        img = img[None]
    if grid.ndim == 3:
        grid = grid.expand((img.shape[0],) + tuple(grid.shape))
    h, w = img.shape[-2:]
    if align_corners:
        ix = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
        iy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
        iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    out = sample_px(img, ix, iy, padding=padding, fill=fill)
    return out if batched else out[0]


def base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """The identity grid [h,w,2], xy in [-1, 1] (align_corners spacing)."""
    yy = torch.linspace(-1.0, 1.0, h, device=device)
    xx = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def inverse_affine_px(angle_deg, translate, scale, shear_deg, device=None):
    """torchvision's `_get_inverse_affine_matrix` with center (0, 0) and no
    y-shear, in float32 on `device`: (inv [2,2], t [2]) with
    src_centered = inv @ (dst_centered - t) in centered pixel
    coordinates."""
    rot = _f32(angle_deg, device) * (math.pi / 180)
    sx = _f32(shear_deg, device) * (math.pi / 180)
    a = torch.cos(rot)
    b = -torch.cos(rot) * torch.tan(sx) - torch.sin(rot)
    c = torch.sin(rot)
    d = -torch.sin(rot) * torch.tan(sx) + torch.cos(rot)
    scale = _f32(scale, device)
    inv = torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) / scale
    t = torch.stack([_f32(v, device) for v in translate])
    return inv, t


def tv_affine(img: torch.Tensor, angle_deg, translate=(0.0, 0.0), scale=1.0,
              shear_deg=0.0, fill: float = 0.0) -> torch.Tensor:
    """`torchvision.transforms.functional.affine` (tensor path, bilinear,
    constant fill) on [B,C,H,W] or [C,H,W]: rotation about the centre,
    translation in pixels, x-shear."""
    batched = img.ndim == 4
    if not batched:
        img = img[None]
    b, _, h, w = img.shape
    dev = img.device
    inv, t = inverse_affine_px(angle_deg, translate, scale, shear_deg, dev)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=dev) - cx
    ys = torch.arange(h, dtype=torch.float32, device=dev) - cy
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dx = gx - t[0]
    dy = gy - t[1]
    sx = inv[0, 0] * dx + inv[0, 1] * dy + cx
    sy = inv[1, 0] * dx + inv[1, 1] * dy + cy
    sx = sx.expand((b,) + tuple(sx.shape))
    sy = sy.expand((b,) + tuple(sy.shape))
    out = sample_px(img, sx, sy, padding="zeros", fill=fill)
    return out if batched else out[0]


def homography_grid(mat3: torch.Tensor, h: int, w: int):
    """A 3x3 inverse homography in pixel coordinates -> the pixel sampling
    coordinates (ix, iy), each [h,w]."""
    dev = mat3.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    src = torch.einsum("ij,hwj->hwi", mat3.float(), pts)
    return (src[..., 0] / (src[..., 2] + 1e-8),
            src[..., 1] / (src[..., 2] + 1e-8))


def frame_transform(img: torch.Tensor, size, angle, shift, scale,
                    shear) -> torch.Tensor:
    """The per-frame motion: `tv_affine` (bilinear, zero fill) by angle
    (degrees), shift (x, y pixels), scale and shear (degrees); a
    size-preserving warp needs no crop."""
    del size
    return tv_affine(img, angle, (shift[0], shift[1]), scale, shear)
