"""The image side of a step, plain: the FFT and pixel decodes with the
colour head, the bicubic cutouts, the `fast` augmentation (perspective as
its least-squares affine fit, composed with the rotation, warped by
shear / scale / shear; random erasing; CLIP normalisation), the frame's
uint8 render and the video frame's affine motion.

The decodes and the frame motion are float32 in the program; the cut and
the augmentation's warp run in bf16 there.  A `Precision` rounds them
for the control."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import REFERENCE

COLOR_SVD_SQRT = np.asarray([[0.26, 0.09, 0.02],
                             [0.27, 0.00, -0.05],
                             [0.27, -0.09, 0.03]], dtype=np.float64)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
ROT_ANGLES = tuple(float(a) for a in list(range(-30, 30)) + [0] * 20)


# ---------------------------------------------------------------- decodes

def color_matrix(colors: float, device) -> torch.Tensor:
    """Lucid's colour decorrelation with the first row over `colors`,
    over its largest column norm, transposed for `image @ M`."""
    m = COLOR_SVD_SQRT / np.asarray([colors, 1.0, 1.0])[:, None]
    m = m / np.linalg.norm(m, axis=0).max()
    return torch.tensor(m.T, dtype=torch.float32, device=device)


def to_rgb(image, colors: float):
    return torch.sigmoid(torch.einsum("nchw,cd->ndhw", image,
                                      color_matrix(colors, image.device)))


def fft_scale(h: int, w: int, decay: float, device) -> torch.Tensor:
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[:w // 2 + 1]
    freqs = np.sqrt(fx * fx + fy * fy)
    scale = 1.0 / np.maximum(freqs, 4.0 / max(h, w)) ** decay
    scale *= np.sqrt(h * w)
    return torch.tensor(scale[None, None, :, :, None], dtype=torch.float32,
                        device=device)


def spectrum_to_image(spec, size):
    """Ortho inverse FFT of a [.., h, w//2+1, 2] spectrum as the program
    defines it for a non-Hermitian spectrum: a complex inverse FFT over
    rows, then a real inverse FFT over columns with the imaginary parts
    of the DC and Nyquist columns dropped."""
    h, w = size
    z = torch.fft.ifft(torch.complex(spec[..., 0], spec[..., 1]), n=h,
                       dim=-2, norm="ortho")
    keep = torch.ones(z.shape[-1], device=z.device)
    keep[0] = 0.0
    if w % 2 == 0:
        keep[w // 2] = 0.0
    return torch.fft.irfft(torch.complex(z.real, z.imag * keep), n=w,
                           dim=-1, norm="ortho")


def fft_image(spec, size, decay: float, colors: float, contrast=1.0,
              prec=REFERENCE):
    img = spectrum_to_image(fft_scale(*size, decay, spec.device) * spec,
                            size)
    img = img * contrast / torch.std(img, dim=(1, 2, 3), keepdim=True)
    return prec.hi(to_rgb(img, colors))


def pixel_image(params, colors: float, contrast=1.0, prec=REFERENCE):
    img = params * contrast / torch.std(params)
    return prec.hi(to_rgb(img, colors))


def render(img) -> torch.Tensor:
    """[1, 3, H, W] in [0, 1] -> [H, W, 3] uint8, rounded half up."""
    img = torch.clamp(img[0].permute(1, 2, 0), 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)


def clip_normalize(x):
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


# ---------------------------------------------------------------- cutouts

def _cubic(t):
    """Cubic convolution (A = -0.75, torch's bicubic) at the taps
    floor-1 .. floor+2 for fractional offsets t."""
    a = -0.75

    def near(x):
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return torch.stack([far(t + 1), near(t), near(1 - t), far(2 - t)], -1)


def axis_matrix(out: int, csize, offset, n_src: int, src_map):
    """[S, out, n_src] bicubic resize (align_corners) of each crop
    (`csize` long, at `offset` in padded coordinates) to `out` samples,
    its taps clamped to the crop and sent through `src_map` (padded index
    -> frame index)."""
    size = csize.float()
    step = (size - 1.0) / torch.full_like(size, float(max(out - 1, 1)))
    src = torch.arange(out, dtype=torch.float32,
                       device=size.device) * step[:, None]
    y0 = torch.floor(src)
    wts = _cubic(src - y0)
    taps = y0[..., None] + torch.arange(-1, 3, device=size.device)
    taps = torch.minimum(taps.clamp(min=0.0), (size - 1.0)[:, None, None])
    idx = src_map[(taps.long() + offset.long()[:, None, None])]
    m = torch.zeros(csize.shape[0], out, n_src, device=size.device)
    return m.scatter_add_(2, idx, wts)


def pad_map(n: int, padded: int, device) -> torch.Tensor:
    """Padded index -> frame index of a frame tiled by repetition with
    the pad split evenly (centre)."""
    p0 = (padded - n) // 2
    return (torch.arange(padded, device=device) - p0) % n


def cut(img, boxes, frame, padded, modsize: int, prec=REFERENCE):
    """[1, 3, H, W] -> cutouts [S, 3, M, M]: each box (csize, offx, offy)
    cropped from the padded frame and resized bicubically."""
    (h, w), (hp, wp) = frame, padded
    csize, offx, offy = boxes
    wy = axis_matrix(modsize, csize, offy, h, pad_map(h, hp, img.device))
    wx = axis_matrix(modsize, csize, offx, w, pad_map(w, wp, img.device))
    q = prec.lo
    tmp = torch.einsum("snw,chw->scnh", q(wx), q(img[0]))
    return torch.einsum("smh,scnh->scmn", q(wy), q(tmp))


# ---------------------------------------------------------------- fast aug

def perspective_coeffs(start, end):
    """torchvision's perspective coefficients, solved: 8 numbers a
    sample mapping output pixel coordinates to input ones."""
    s = end.shape[0]
    a = torch.zeros(s, 8, 8, dtype=torch.float64, device=end.device)
    b = start.double().reshape(1, 8).expand(s, 8)
    e = end.double()
    for i in range(4):
        ex, ey = e[:, i, 0], e[:, i, 1]
        sx, sy = start[i, 0].double(), start[i, 1].double()
        one, zero = torch.ones_like(ex), torch.zeros_like(ex)
        a[:, 2 * i] = torch.stack([ex, ey, one, zero, zero, zero,
                                   -sx * ex, -sx * ey], -1)
        a[:, 2 * i + 1] = torch.stack([zero, zero, zero, ex, ey, one,
                                       -sy * ex, -sy * ey], -1)
    return torch.linalg.solve(a, b)


def affine_fit(coef, h: int, w: int, grid_n: int = 5):
    """Least-squares affine map [S, 2, 3] in centred pixel coordinates
    of the homography `coef`, over a grid_n x grid_n grid of the cut."""
    dev = coef.device
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    gy, gx = torch.meshgrid(
        torch.linspace(0.0, h - 1.0, grid_n, dtype=torch.float64, device=dev),
        torch.linspace(0.0, w - 1.0, grid_n, dtype=torch.float64, device=dev),
        indexing="ij")
    x, y = gx.reshape(-1) + 0.5, gy.reshape(-1) + 0.5
    a, b, c, d, e, f, g, hh = coef.unbind(-1)
    den = g[:, None] * x + hh[:, None] * y + 1.0
    sx = (a[:, None] * x + b[:, None] * y + c[:, None]) / den - 0.5 - cx
    sy = (d[:, None] * x + e[:, None] * y + f[:, None]) / den - 0.5 - cy
    design = torch.stack([gx.reshape(-1) - cx, gy.reshape(-1) - cy,
                          torch.ones_like(x)], -1)
    sol = torch.linalg.lstsq(design.expand(coef.shape[0], -1, -1),
                             torch.stack([sx, sy], -1)).solution
    return sol.transpose(1, 2).float()


def rotation(rot_idx):
    r = torch.deg2rad(torch.tensor(ROT_ANGLES, device=rot_idx.device)[
        rot_idx.long()])
    cos, sin = torch.cos(r), torch.sin(r)
    return torch.stack([torch.stack([cos, sin], -1),
                        torch.stack([-sin, cos], -1)], -2)


def bilinear_matrix(scale, offset, n: int, n_in: int, dst0=0.0, src0=0.0):
    """[S, n, n_in] linear resampling: output j reads the input at
    scale (j + dst0 - c) + c + offset - src0, c the middle of the longer
    of the two padded axes; taps outside the input read 0."""
    dev = scale.device
    c = (max(n + 2 * dst0, n_in + 2 * src0) - 1) / 2.0
    dst = torch.arange(n, dtype=torch.float32, device=dev) + dst0
    src = scale[:, None] * (dst - c) + c + offset[:, None] - src0
    i0 = torch.floor(src)
    t = src - i0
    iota = torch.arange(n_in, dtype=torch.float32, device=dev)
    return ((iota == i0[..., None]).float() * (1 - t)[..., None]
            + (iota == (i0 + 1)[..., None]).float() * t[..., None])


def _shift_fft(x, shift, dim: int, n: int, q):
    """Band-limited translation along `dim` (length n, zero padded) by
    `shift` (broadcast against the other axes) through the FFT."""
    spec = torch.fft.rfft(x, dim=dim)
    k = torch.arange(spec.shape[dim], dtype=torch.float32, device=x.device)
    shape = [1] * x.ndim
    shape[dim] = -1
    ang = -2.0 * math.pi * k.view(shape) * shift / n
    phase = torch.complex(torch.cos(ang), torch.sin(ang))
    return q(torch.fft.irfft(spec * phase, n=n, dim=dim))


def affine_warp(cuts, aff, pad: int, prec=REFERENCE):
    """Each cutout warped by its inverse affine map (src = A dst + t in
    centred coordinates) as A = L D U: a per-column vertical shift, a
    bilinear rescale of both axes with the translation, a per-row
    horizontal shift; the shifts by Fourier phase over the cut zero
    padded by `pad` a side."""
    q = prec.lo
    s, c, h, w = cuts.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    a2, t = aff[:, :, :2], aff[:, :, 2]
    a00, a01, a10, a11 = a2[:, 0, 0], a2[:, 0, 1], a2[:, 1, 0], a2[:, 1, 1]
    l, d1, u = a10 / a00, a00, a01 / a00
    d2 = a11 - a10 * a01 / a00
    xs = torch.arange(w, dtype=torch.float32, device=cuts.device) - (w - 1) / 2
    ys = torch.arange(h, dtype=torch.float32, device=cuts.device) - (h - 1) / 2
    x = F.pad(q(cuts), (0, 0, pad, pad))
    y = _shift_fft(x, -(l[:, None] * xs)[:, None, None, :], 2, hp, q)
    my = bilinear_matrix(d2, t[:, 1] - l * t[:, 0], h, hp, dst0=pad)
    x2 = q(torch.einsum("soh,schw->scow", q(my), y))
    mx = bilinear_matrix(d1, t[:, 0], wp, w, src0=pad)
    z = q(torch.einsum("svw,scow->scov", q(mx), x2))
    out = _shift_fft(z, -(u[:, None] * ys)[:, None, :, None], 3, wp, q)
    return out[..., pad:pad + w]


def erase(draws, cuts):
    """torchvision RandomErasing's rectangles set to 0 where drawn."""
    apply, area, logr, y0u, x0u = draws
    s, c, h, w = cuts.shape
    r = torch.exp(logr)
    eh = torch.clamp(torch.sqrt(area * h * w * r), 1, h - 1)
    ew = torch.clamp(torch.sqrt(area * h * w / r), 1, w - 1)
    y0, x0 = y0u * (h - eh), x0u * (w - ew)
    yy = torch.arange(h, dtype=torch.float32, device=cuts.device)[None, :,
                                                                  None]
    xx = torch.arange(w, dtype=torch.float32, device=cuts.device)[None, None]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + eh)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + ew)[:, None, None]))
    return torch.where((inside & apply[:, None, None])[:, None],
                       torch.zeros_like(cuts), cuts)


def augment_fast(draws, cuts, prec=REFERENCE):
    """`fast`: perspective (as its affine fit) then rotation in one warp
    with 56 pixels of padding, erasing, CLIP normalisation."""
    endpoints, rot_idx, erasing = draws
    s, c, h, w = cuts.shape
    start = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                         dtype=torch.float32, device=cuts.device)
    fit = affine_fit(perspective_coeffs(start, endpoints), h, w)
    rot = rotation(rot_idx)
    aff = torch.cat([fit[:, :, :2] @ rot, fit[:, :, 2:]], -1)
    out = affine_warp(cuts, aff, 56, prec)
    return prec.lo(clip_normalize(erase(erasing, out)))


# ---------------------------------------------------------------- motion

def frame_motion(img, angle, shift, scale, shear):
    """torchvision's `affine` (bilinear, zero fill, centre of the frame)
    by angle (degrees), shift (pixels), scale and x-shear (degrees)."""
    _, _, h, w = img.shape
    dev = img.device
    rot = torch.tensor(math.radians(angle), device=dev)
    sh = torch.tensor(math.radians(shear), device=dev)
    a = torch.cos(rot)
    b = -torch.cos(rot) * torch.tan(sh) - torch.sin(rot)
    c = torch.sin(rot)
    d = -torch.sin(rot) * torch.tan(sh) + torch.cos(rot)
    inv = torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) / scale
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) - cy,
        torch.arange(w, dtype=torch.float32, device=dev) - cx, indexing="ij")
    dx, dy = gx - shift[0], gy - shift[1]
    sx = inv[0, 0] * dx + inv[0, 1] * dy + cx
    sy = inv[1, 0] * dx + inv[1, 1] * dy + cy
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1)
    return F.grid_sample(img, grid[None], mode="bilinear",
                         padding_mode="zeros", align_corners=True)
