"""Separable affine warping (counterpart of aphantasia_tpu.ops.sep_warp).

A per-sample affine inverse map A = L D U (shear-y, scale, shear-x) is
applied as a chain of per-sample matrix products: the shears are
fractional shifts by DFT phase rotation, the scales are two-tap bilinear
resample matrices, and the DFT synthesis/analysis matrices fold into the
scale matrices (`affine_warp`), so the whole warp is four batched
matmuls plus two phase rotations (`_FusedWarp`).  Inputs are zero-padded
in the DFT so wrap-around never reaches the output crop.

These are plain large matmuls, not a TPU kernel: the JAX package left them
to XLA, and here they go to `torch.einsum`.  `fractional_shift` (the only
caller of the Pallas shift kernel) is reached only from the `elastic`
pipeline, which is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dft_mats(n: int):
    """Real DFT analysis/synthesis matrices (numpy, float32):
    (cos_f [n,nf], sin_f [n,nf], cos_i [nf,n], sin_i [nf,n]) with the
    irfft weighting folded into the synthesis matrices."""
    nf = n // 2 + 1
    j = np.arange(n)[:, None]
    k = np.arange(nf)[None, :]
    ang = 2.0 * np.pi * j * k / n
    cos_f = np.cos(ang).astype(np.float32)
    sin_f = -np.sin(ang).astype(np.float32)
    w = np.full(nf, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cos_i = (np.cos(ang) * w[None, :] / n).astype(np.float32).T
    sin_i = (np.sin(ang) * w[None, :] / n).astype(np.float32).T
    return cos_f, sin_f, cos_i, sin_i


@functools.lru_cache(maxsize=32)
def _dft_mats_packed(n: int):
    """Analysis [n, 2nf] = [cos|sin] and synthesis [2nf, n] = [[cos],[-sin]]."""
    cos_f, sin_f, cos_i, sin_i = _dft_mats(n)
    return (np.concatenate([cos_f, sin_f], axis=1),
            np.concatenate([cos_i, -sin_i], axis=0))


@functools.lru_cache(maxsize=64)
def _packed_tensors(n: int, dtype: torch.dtype, device: str):
    return tuple(torch.as_tensor(m, device=device).to(dtype)
                 for m in _dft_mats_packed(n))


def scale_matrix_1d(scale, offset, n: int, dtype=torch.float32,
                    n_in: int | None = None, dst0: float = 0.0,
                    src0: float = 0.0):
    """Per-sample 1D bilinear resample matrices [S, n, n_in] with
    src = scale * (dst + dst0 - c) + c + offset - src0 and
    c = (max(n + 2*dst0, n_in + 2*src0) - 1) / 2.  Out-of-range taps drop
    (zero padding outside)."""
    n_in = n if n_in is None else n_in
    dev = scale.device
    dst = torch.arange(n, dtype=torch.float32, device=dev) + dst0
    c = (max(n + 2 * dst0, n_in + 2 * src0) - 1) / 2.0
    src = scale[:, None] * (dst - c) + c + offset[:, None] - src0
    i0 = torch.floor(src)
    t = src - i0
    iota = torch.arange(n_in, dtype=torch.float32, device=dev)
    m0 = ((iota[None, None, :] == i0[:, :, None]).to(dtype)
          * (1 - t)[:, :, None].to(dtype))
    m1 = ((iota[None, None, :] == (i0 + 1)[:, :, None]).to(dtype)
          * t[:, :, None].to(dtype))
    return m0 + m1


def ldu_decompose(a2):
    """Per-sample LDU of [S,2,2] inverse-warp matrices:
    A = [[1,0],[l,1]] @ diag(d1,d2) @ [[1,u],[0,1]] (needs a00 != 0)."""
    a00, a01 = a2[:, 0, 0], a2[:, 0, 1]
    a10, a11 = a2[:, 1, 0], a2[:, 1, 1]
    return a10 / a00, a00, a11 - a10 * a01 / a00, a01 / a00


def _phase_mul(fr, fi, c, s):
    """(fr + i fi) * (c + i s); the adjoint is the same op at (c, -s)."""
    return fr * c - fi * s, fr * s + fi * c


def _geom_mats(h, w, pad, dt, device):
    a_h = _packed_tensors(h + 2 * pad, dt, str(device))[0][pad:pad + h]
    s_w = _packed_tensors(w + 2 * pad, dt, str(device))[1][:, pad:pad + w]
    return a_h, s_w, (h + 2 * pad) // 2 + 1, (w + 2 * pad) // 2 + 1


class _FusedWarp(torch.autograd.Function):
    """The 4-matmul LDU warp core: analysis_H -> y-phase -> My2 ->
    Mx2 -> x-phase -> windowed synthesis_W.  Linear in x; the per-sample
    matrices and phases come from the random draw and get no gradient, so
    the backward is the transposed chain with conjugate phases."""

    @staticmethod
    def forward(ctx, x, my2, mx2, cy, sy, cx, sx, geom, dt):
        h, w, pad = geom
        a_h, s_w, nfh, nfw = _geom_mats(h, w, pad, dt, x.device)
        ctx.save_for_backward(my2, mx2, cy, sy, cx, sx)
        ctx.geom, ctx.dt = geom, dt
        f = torch.einsum("hk,schw->sckw", a_h, x.to(dt))           # [S,C,2nfh,W]
        gr, gi = _phase_mul(f[:, :, :nfh], f[:, :, nfh:],
                            cy[:, None], sy[:, None])
        g = torch.cat([gr, gi], dim=2)
        x2 = torch.einsum("sko,sckw->scow", my2, g)                # [S,C,H,W]
        f2 = torch.einsum("swk,scow->scok", mx2, x2)               # [S,C,H,2nfw]
        g2r, g2i = _phase_mul(f2[..., :nfw], f2[..., nfw:],
                              cx[:, None], sx[:, None])
        g2 = torch.cat([g2r, g2i], dim=-1)
        return torch.einsum("scok,kn->scon", g2, s_w).float()

    @staticmethod
    def backward(ctx, dout):
        my2, mx2, cy, sy, cx, sx = ctx.saved_tensors
        h, w, pad = ctx.geom
        dt = ctx.dt
        a_h, s_w, nfh, nfw = _geom_mats(h, w, pad, dt, dout.device)
        dg2 = torch.einsum("scon,kn->scok", dout.to(dt), s_w)
        dfr, dfi = _phase_mul(dg2[..., :nfw], dg2[..., nfw:],
                              cx[:, None], -sx[:, None])
        df2 = torch.cat([dfr, dfi], dim=-1)
        dx2 = torch.einsum("swk,scok->scow", mx2, df2)
        dg = torch.einsum("sko,scow->sckw", my2, dx2)
        dgr, dgi = _phase_mul(dg[:, :, :nfh], dg[:, :, nfh:],
                              cy[:, None], -sy[:, None])
        df = torch.cat([dgr, dgi], dim=2)
        dx = torch.einsum("hk,sckw->schw", a_h, df).float()
        return (dx,) + (None,) * 8


def affine_warp(cuts, affines, pad: int = 64, fill: float = 0.0,
                compute_dtype=None):
    """Per-sample affine warp of [S,C,H,W] by inverse maps [S,2,3]
    (src_centered = A2 @ dst_centered + t).

    With A2 = L D U the pass chain is L (per-column y-shift by DFT phase),
    D (two per-sample scale matrices whose offsets absorb the translation
    L^-1 t), U (per-row x-shift).  The L synthesis folds into the y-scale
    (My2 = synth_Hp . my^T) and the x-scale into the U analysis
    (Mx2 = mx^T . anal_Wp), so four batched matmuls remain.  The matmuls
    run in `compute_dtype` (float32 by default) and each product is
    rounded to it, as the JAX package's `preferred_element_type` does."""
    s, c, h, w = cuts.shape
    dt = compute_dtype or torch.float32
    dev = cuts.device
    hp, wp = h + 2 * pad, w + 2 * pad
    nfh, nfw = hp // 2 + 1, wp // 2 + 1
    affines = affines.float()
    a2, t = affines[:, :, :2], affines[:, :, 2]
    l, d1, d2, u = ldu_decompose(a2)
    xs = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0

    # L pass phases: src_y = y + l*x  =>  shift = -(l*x) per column
    shift_y = -(l[:, None] * xs[None, :])                          # [S,W]
    ky = torch.arange(nfh, dtype=torch.float32, device=dev)
    phi_y = -2.0 * np.pi * ky[None, :, None] * shift_y[:, None, :] / hp
    cy, sy = torch.cos(phi_y).to(dt), torch.sin(phi_y).to(dt)      # [S,nfh,W]

    # D pass matrices with translation L^-1 t = (tx, ty - l*tx) as offsets
    my = scale_matrix_1d(d2, t[:, 1] - l * t[:, 0], h, dtype=dt, n_in=hp,
                         dst0=pad)                                 # [S,H,Hp]
    mx = scale_matrix_1d(d1, t[:, 0], wp, dtype=dt, n_in=w,
                         src0=pad)                                 # [S,Wp,W]
    synth_h = _packed_tensors(hp, dt, str(dev))[1]                 # [2nfh,Hp]
    a_w = _packed_tensors(wp, dt, str(dev))[0]                     # [Wp,2nfw]
    my2 = torch.einsum("kh,soh->sko", synth_h, my)                 # [S,2nfh,H]
    mx2 = torch.einsum("svw,vk->swk", mx, a_w)                     # [S,W,2nfw]

    # U pass phases: src_x = x + u*y  =>  shift = -(u*y) per row
    shift_x = -(u[:, None] * ys[None, :])                          # [S,H]
    kx = torch.arange(nfw, dtype=torch.float32, device=dev)
    phi_x = -2.0 * np.pi * kx[None, None, :] * shift_x[:, :, None] / wp
    cx, sx = torch.cos(phi_x).to(dt), torch.sin(phi_x).to(dt)      # [S,H,nfw]

    x = cuts - fill if fill != 0.0 else cuts
    out = _FusedWarp.apply(x, my2, mx2, cy, sy, cx, sx, (h, w, pad), dt)
    if fill != 0.0:
        out = out + fill
    return out.to(cuts.dtype)
