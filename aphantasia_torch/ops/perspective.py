"""Perspective draw, homography algebra and the exact warp's plain version
(counterpart of aphantasia_tpu.ops.perspective).

The `fast` augmentation draws a torchvision RandomPerspective(0.33, p=0.2)
per cutout and solves its homography.  The default (`--persp affine`)
enters the affine warp as the least-squares affine FIT of that homography;
`--persp mixed|exact` applies the homography itself through the CUDA
kernels of ops/persp.py, whose plain version is `homography_warp` here:
torchvision's `F.perspective` / `F.affine` semantics (a grid over output
pixel centres mapped through the rational transform, 4-tap bilinear with
zero padding, and the whole pixel scaled by the sum of in-bounds tap
weights, torchvision's fill-0 mask):

    sx = (a*(x+.5) + b*(y+.5) + c) / (g*(x+.5) + h*(y+.5) + 1) - 0.5
    sy = (d*(x+.5) + e*(y+.5) + f) / (same denominator)        - 0.5

The JAX package gives `homography_warp` a custom VJP that gathers over a
window around the inverse map (a way around XLA's slow TPU scatter); here
the plain backward is autograd's exact transpose, and the windowed gather
lives in the CUDA backward kernel (csrc/persp.cu).
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=32)
def start_points(h: int, w: int, device) -> torch.Tensor:
    """The four corners [4,2] float32 of an h x w image (topleft, topright,
    botright, botleft), built once per device: a per-call host table is a
    pageable copy, which makes the host wait for the card and which a
    CUDA graph refuses.  Shared: never written to."""
    return torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                        dtype=torch.float32, device=device)


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
    startpoints = start_points(h, w, dev)
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


def affine_rotation_coeffs(angles_deg):
    """[S] degrees -> [S,4] (cos, sin, -sin, cos): the inverse map
    (output -> input) of a rotation about the frame centre."""
    r = torch.deg2rad(angles_deg)
    cos, sin = torch.cos(r), torch.sin(r)
    return torch.stack([cos, sin, -sin, cos], -1)


def rotation_coeffs_for(angles_deg, h: int, w: int):
    """torchvision F.affine(angle, fill=0) rotation of an HxW frame as
    8 homography coeffs [S,8]: src = R^-1 (p - ctr) + ctr with
    ctr = (w/2, h/2) in the (x+0.5) pixel-centre frame."""
    rc = affine_rotation_coeffs(angles_deg)
    cos, sin = rc[:, 0], rc[:, 1]
    cx, cy = w / 2.0, h / 2.0
    a, b = cos, sin
    d, e = -sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    z = torch.zeros_like(a)
    return torch.stack([a, b, c, d, e, f, z, z], -1)


def _coef_matrix(coef):
    s = coef.shape[0]
    return torch.cat([coef, torch.ones((s, 1), dtype=coef.dtype,
                                       device=coef.device)], -1).reshape(s, 3, 3)


def compose_coeffs(c1, c2):
    """Coeffs [S,8] of warp-by-c1 THEN warp-by-c2 as one homography (the
    cut is sampled at M1 @ M2 @ p), normalized to m22 = 1."""
    m = torch.bmm(_coef_matrix(c1), _coef_matrix(c2))
    m = m / m[:, 2:3, 2:3]
    return m.reshape(-1, 9)[:, :8]


def _inverse_coeffs(coef):
    """The inverse homography [S,3,3] (adjugate, normalized to m22 = 1):
    maps an input pixel centre to the output position sampling it."""
    adj = _adjugate3(_coef_matrix(coef))
    return adj / adj[:, 2:3, 2:3]


def _grids(h: int, w: int, device):
    xg = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    yg = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    yy, xx = torch.meshgrid(yg, xg, indexing="ij")
    return xx, yy


def homography_warp(img, coef):
    """img [S,C,H,W], coef [S,8] -> warped [S,C,H,W] in img's dtype:
    torchvision bilinear + zeros padding + fill-0 mask.  Positions,
    weights and sums are float32 (a bf16 image is read as float32 and
    the result rounded once).  Differentiable in img through autograd."""
    s, c, h, w = img.shape
    xx, yy = _grids(h, w, img.device)
    sx, sy = _src_positions(coef.float(), xx, yy)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    tx = sx - x0
    ty = sy - y0
    flat = img.float().reshape(s, c, h * w)
    out = torch.zeros((s, c, h, w), dtype=torch.float32, device=img.device)
    mask = torch.zeros((s, h, w), dtype=torch.float32, device=img.device)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
            ok = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).float()
            idx = (torch.clamp(yi, 0, h - 1) * w
                   + torch.clamp(xi, 0, w - 1)).long()
            tap = torch.gather(flat, 2, idx.reshape(s, 1, h * w)
                               .expand(s, c, h * w))
            out = out + tap.reshape(s, c, h, w) * (wgt * ok)[:, None]
            mask = mask + wgt * ok
    return (out * mask[:, None]).to(img.dtype)
