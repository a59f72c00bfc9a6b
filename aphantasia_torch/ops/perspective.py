"""Perspective draw and its affine fit (counterpart of
aphantasia_tpu.ops.perspective, the part the default `fast` pipeline uses).

The `fast` augmentation draws a torchvision RandomPerspective(0.33, p=0.2)
per cutout, solves its homography, and enters the affine warp as the
least-squares affine FIT of that homography.  `homography_warp` (the exact
warp) is not ported yet; it comes with the `--persp` kernel (ROADMAP.md).
"""
from __future__ import annotations

import torch


def perspective_endpoints(generator: torch.Generator, s: int, h: int, w: int,
                          distortion: float = 0.33, p: float = 0.2):
    """torchvision RandomPerspective.get_params, batched: integer corner
    displacements via randint, identity (startpoints) with prob 1-p.

    Returns (startpoints [4,2], endpoints [s,4,2]) float32 pixel coords,
    corners ordered topleft, topright, botright, botleft."""
    dev = generator.device
    half_h, half_w = h // 2, w // 2
    dw = int(distortion * half_w)
    dh = int(distortion * half_h)

    def rint(lo, hi):
        return torch.randint(lo, hi, (s,), generator=generator, device=dev)

    tl = torch.stack([rint(0, dw + 1), rint(0, dh + 1)], -1)
    tr = torch.stack([rint(w - dw - 1, w), rint(0, dh + 1)], -1)
    br = torch.stack([rint(w - dw - 1, w), rint(h - dh - 1, h)], -1)
    bl = torch.stack([rint(0, dw + 1), rint(h - dh - 1, h)], -1)
    endpoints = torch.stack([tl, tr, br, bl], 1).float()
    startpoints = torch.tensor(
        [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=torch.float32,
        device=dev)
    apply = (torch.rand(s, generator=generator, device=dev) < p)[:, None, None]
    endpoints = torch.where(apply, endpoints, startpoints.expand_as(endpoints))
    return startpoints, endpoints


def _unit_to_quad(q):
    """Heckbert's closed-form projective map unit square -> quad.
    q: [s,4,2]; returns [s,3,3]."""
    x0, y0 = q[:, 0, 0], q[:, 0, 1]
    x1, y1 = q[:, 1, 0], q[:, 1, 1]
    x2, y2 = q[:, 2, 0], q[:, 2, 1]
    x3, y3 = q[:, 3, 0], q[:, 3, 1]
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    one = torch.ones_like(a)
    return torch.stack([a, b, x0, d, e, y0, g, h, one], -1).reshape(-1, 3, 3)


def _adjugate3(m):
    """Batched 3x3 adjugate."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    return torch.stack([
        e * i - f * h, c * h - b * i, b * f - c * e,
        f * g - d * i, a * i - c * g, c * d - a * f,
        d * h - e * g, b * g - a * h, a * e - b * d,
    ], -1).reshape(-1, 3, 3)


def perspective_coeffs(startpoints, endpoints):
    """torchvision _get_perspective_coeffs, batched: 8 coeffs per sample
    mapping output pixel coords to input coords, as
    H = (unit->start) @ adj(unit->end), normalized to m22 = 1."""
    s = endpoints.shape[0]
    sp = startpoints[None].expand(s, 4, 2).float()
    m = torch.bmm(_unit_to_quad(sp), _adjugate3(_unit_to_quad(endpoints.float())))
    m = m / m[:, 2:3, 2:3]
    return m.reshape(s, 9)[:, :8]


def _src_positions(coef, xx, yy):
    """coef [s,8]; xx/yy pixel-center grids (x+0.5).  Returns the input
    sampling positions (sx, sy) in pixel coords (torchvision convention)."""
    a, b, c, d, e, f, g, h = [coef[:, i][:, None, None] for i in range(8)]
    den = g * xx + h * yy + 1.0
    sx = (a * xx + b * yy + c) / den - 0.5
    sy = (d * xx + e * yy + f) / den - 0.5
    return sx, sy


def affine_fit_centered(coef, h: int, w: int, grid_n: int = 5):
    """Least-squares affine fit of the homography over a grid_n x grid_n
    point grid, in the centered pixel coordinates `affine_warp` consumes.
    Returns [s,2,3]."""
    s = coef.shape[0]
    dev = coef.device
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    gx = torch.linspace(0.0, w - 1.0, grid_n, device=dev)
    gy = torch.linspace(0.0, h - 1.0, grid_n, device=dev)
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    sx, sy = _src_positions(coef, xx[None] + 0.5, yy[None] + 0.5)
    dstx = (xx - cx).reshape(-1)
    dsty = (yy - cy).reshape(-1)
    srcx = sx.reshape(s, -1) - cx
    srcy = sy.reshape(s, -1) - cy
    x_ = torch.stack([dstx, dsty, torch.ones_like(dstx)], -1)   # [n,3]
    xtx = x_.T @ x_
    adj = _adjugate3(xtx[None])[0]
    det = xtx[0, 0] * adj[0, 0] + xtx[0, 1] * adj[1, 0] + xtx[0, 2] * adj[2, 0]
    inv = adj / det
    row_x = (srcx @ x_) @ inv.T
    row_y = (srcy @ x_) @ inv.T
    return torch.stack([row_x, row_y], 1)
