"""The cutout crop-and-resize as a hand-written CUDA kernel pair
(csrc/cutout.cu), with its plain PyTorch version beside it.

    out[s,c,m,n] = sum_a sum_b yw[s,m,a] * xw[s,n,b]
                   * img[c, yidx[s,m,a], xidx[s,n,b]]

Replaces the Pallas kernels of aphantasia_tpu/ops/pallas_cutout.py:
`_pallas_cut_fwd` (pallas_call at :109) and `_pallas_cut_bwd` (:139).  The
TPU kernel builds dense Wy/Wx per sample and runs two MXU matmuls with the
frame pinned in VMEM; here each output is a direct 16-tap gather, so no
dense matrix and no [S,C,M,W] intermediate exist.  The backward
(`_pallas_cut_bwd`'s transpose, bound by reading g once: 0.040 ms at S=200,
M=224, 720x1280) has each block own a 32x32 tile of d_img and gather what
the crops put there, walking the samples in order after a pre-pass that
finds which rows and columns of each crop reach each tile: every pixel is
written once, by one sum in a fixed order, so no float32 atomics and the
same bits on every run (csrc/cutout.cu explains the design).

`cutout()` launches the kernels for a CUDA image and runs `cutout_plain`
for a CPU image; anything else raises.
"""
from __future__ import annotations

import torch

from aphantasia_torch import kernels

_SIGNATURES = {
    "cutout_fwd": [kernels.PTR] * 6 + [kernels.INT] * 5 + [kernels.PTR],
    "cutout_bwd": [kernels.PTR] * 8 + [kernels.INT] * 7 + [kernels.PTR],
    "cutout_table_width": [kernels.INT] * 2,
}
TILE = 32    # frame pixels a side of the backward's tiles (csrc/cutout.cu)
# samples a piece of the backward's walk takes at least: a tile's walk is
# cut into up to 4 pieces, summed in order afterwards, so that the tiles
# where many crops pile up are not one block's long serial walk
PIECE = 48


def in_frame(idx, wts, n):
    """Taps outside [0, n) carry no weight (as in the dense matrices,
    whose iota compare never matches them) and are clamped into the frame
    so that no read leaves it.  A crop larger than the frame (a frame
    smaller than the CLIP input) draws such taps."""
    ok = (idx >= 0) & (idx < n)
    return (torch.clamp(idx, 0, n - 1).to(torch.int32),
            torch.where(ok, wts, torch.zeros_like(wts)))


def cutout_plain(img, yidx, yw, xidx, xw):
    """Plain PyTorch version: rows first (gather + weight over the 4
    y-taps -> [S,C,M,W]), then columns (gather + weight over the 4
    x-taps).  Differentiable through autograd."""
    c, h, w = img.shape
    s, m, _ = yidx.shape
    yidx, yw = in_frame(yidx, yw, h)
    xidx, xw = in_frame(xidx, xw, w)
    yi = yidx.long()
    rows = img[:, yi]                                        # [C,S,M,4,W]
    tmp = torch.einsum("csmaw,sma->scmw", rows, yw)          # [S,C,M,W]
    xi = xidx.long().reshape(s, 1, 1, m * 4).expand(s, c, m, m * 4)
    cols = torch.gather(tmp, 3, xi).reshape(s, c, m, m, 4)   # [S,C,M,N,4]
    return torch.einsum("scmnb,snb->scmn", cols, xw)


def _even(k):
    return -(-k // 2) * 2


def table_layout(h, w):
    """(where the row ranges start, where the column ranges start, width)
    of a sample's row of the backward's range table, as csrc/cutout.cu
    lays it out (the kernel's wrapper sizes the table by the library's own
    `cutout_table_width`): the band ranges, then one range per frame row,
    then one per frame column, each segment of an even length."""
    rows_at = _even(-(-h // TILE) - (-w // TILE))
    return rows_at, rows_at + _even(h), rows_at + _even(h) + _even(w)


def tile_ranges(yidx, yw, xidx, xw, h, w):
    """Plain version of the backward's pre-pass: int32 [S, width, 2]
    (`table_layout`), per sample the lowest and highest m with a weighted
    tap in each band of TILE rows, then the n for each band of TILE
    columns; from rows_at the m for each frame row, from cols_at the n for
    each frame column; (2**31 - 1, -1) where none, and in the padding.
    Taps as `in_frame` leaves them."""
    rows_at, cols_at, width = table_layout(h, w)
    out = torch.tensor([2 ** 31 - 1, -1], dtype=torch.int32).repeat(
        yidx.shape[0], width, 1)
    nby = -(-h // TILE)
    for size, y_at, x_at in ((TILE, 0, nby), (1, rows_at, cols_at)):
        for idx, wts, n, at in ((yidx, yw, h, y_at), (xidx, xw, w, x_at)):
            m = idx.shape[1]
            band = idx.long() // size
            hit = (wts != 0)[..., None] & (band[..., None] == torch.arange(
                -(-n // size), device=idx.device))
            q = torch.arange(m, device=idx.device).view(1, m, 1, 1)
            lo = torch.where(hit, q, 2 ** 31 - 1).amin((1, 2))
            hi = torch.where(hit, q, -1).amax((1, 2))
            out[:, at:at + lo.shape[1]] = torch.stack([lo, hi], -1)
    return out


def _checked(img, yidx, yw, xidx, xw):
    if img.dtype != torch.float32 or img.ndim != 3:
        raise TypeError("cutout kernel takes a float32 [C,H,W] image, got "
                        f"{img.dtype} {tuple(img.shape)}")
    s, m, four = yidx.shape
    for t, dt in ((yidx, torch.int32), (xidx, torch.int32),
                  (yw, torch.float32), (xw, torch.float32)):
        if t.shape != (s, m, four) or four != 4 or t.dtype != dt:
            raise TypeError("cutout taps must be [S,M,4] int32 indices and "
                            "float32 weights")
        if t.device != img.device:
            raise ValueError("cutout taps and image must share a device")
    _, h, w = img.shape
    yidx, yw = in_frame(yidx, yw, h)
    xidx, xw = in_frame(xidx, xw, w)
    return (img.contiguous(), yidx.contiguous(), yw.contiguous(),
            xidx.contiguous(), xw.contiguous())


def cutout_fwd_kernel(img, yidx, yw, xidx, xw):
    """Launch the forward kernel: float32 [S,C,M,M]."""
    img, yidx, yw, xidx, xw = _checked(img, yidx, yw, xidx, xw)
    c, h, w = img.shape
    s, m, _ = yidx.shape
    out = torch.empty((s, c, m, m), device=img.device, dtype=torch.float32)
    lib = kernels.library("cutout", _SIGNATURES)
    code = lib.cutout_fwd(img.data_ptr(), yidx.data_ptr(), yw.data_ptr(),
                          xidx.data_ptr(), xw.data_ptr(), out.data_ptr(),
                          c, h, w, s, m, kernels.stream_ptr(img))
    kernels.check(lib, code, "cutout_fwd")
    kernels.LAUNCHES["cutout_fwd"] += 1
    return out


def cutout_bwd_kernel(g, yidx, yw, xidx, xw, img_shape):
    """Launch the backward (the range pre-pass and the tile gather, one
    count): float32 d_img [C,H,W], every element written."""
    c, h, w = img_shape
    g = g.float().contiguous()
    s, m, _ = yidx.shape
    if g.shape != (s, c, m, m):
        raise ValueError(f"cutout grad shape {tuple(g.shape)} != "
                         f"{(s, c, m, m)}")
    dimg = torch.empty((c, h, w), device=g.device, dtype=torch.float32)
    _, yidx, yw, xidx, xw = _checked(dimg, yidx, yw, xidx, xw)
    lib = kernels.library("cutout", _SIGNATURES)
    # the pre-pass's table (`tile_ranges`); TMA reads g by rows of a
    # multiple of 16 bytes
    table = torch.empty((s, lib.cutout_table_width(h, w), 2), device=g.device,
                        dtype=torch.int32)
    if m % 4:
        g = torch.nn.functional.pad(g, (0, 4 - m % 4))
    g = kernels.aligned(g)
    split = min(4, max(1, s // PIECE))
    part = (torch.empty((split, c, h, w), device=g.device,
                        dtype=torch.float32) if split > 1 else dimg)
    code = lib.cutout_bwd(g.data_ptr(), yidx.data_ptr(), yw.data_ptr(),
                          xidx.data_ptr(), xw.data_ptr(), table.data_ptr(),
                          part.data_ptr(), dimg.data_ptr(), c, h, w, s, m,
                          g.shape[-1], split, kernels.stream_ptr(g))
    kernels.check(lib, code, "cutout_bwd")
    kernels.LAUNCHES["cutout_bwd"] += 1
    return dimg


class _CutoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, yidx, yw, xidx, xw):
        img, yidx, yw, xidx, xw = _checked(img, yidx, yw, xidx, xw)
        ctx.save_for_backward(yidx, yw, xidx, xw)
        ctx.img_shape = tuple(img.shape)
        return cutout_fwd_kernel(img, yidx, yw, xidx, xw)

    @staticmethod
    def backward(ctx, g):
        yidx, yw, xidx, xw = ctx.saved_tensors
        return (cutout_bwd_kernel(g, yidx, yw, xidx, xw, ctx.img_shape),
                None, None, None, None)


def cutout(img, yidx, yw, xidx, xw):
    """img [C,H,W] (cast to float32) + taps [S,M,4] -> [S,C,M,M] float32.
    CUDA tensors launch the kernels; CPU tensors run `cutout_plain`."""
    img = img.float()
    if img.is_cuda:
        return _CutoutFn.apply(img, yidx, yw, xidx, xw)
    if img.device.type == "cpu":
        return cutout_plain(img, yidx, yw, xidx, xw)
    raise RuntimeError(f"cutout has no kernel for device {img.device}")
