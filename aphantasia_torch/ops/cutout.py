"""The cutout crop-and-resize as a hand-written CUDA kernel pair
(csrc/cutout.cu), with its plain PyTorch version beside it.

Replaces the Pallas kernels of aphantasia_tpu/ops/pallas_cutout.py:
`_pallas_cut_fwd` (pallas_call at :109) and `_pallas_cut_bwd` (:139).
The forward computes the TPU kernel's function, roundings included: for
each sample s and channel c,

    wy[m, y] = bf16(sum of row m's y-taps on y, in tap order, float32)
    tmp[m, x] = bf16(sum_y wy[m, y] * bf16(img[c, y, x]))      float32 sums
    out[s, c, m, n] = sum_x tmp[m, x] * wx[n, x]                float32

with wx built as wy from the x-taps.  A product of two bf16 values is
exact in float32, so only the sum order is free: both the plain version
and the kernel add the distinct taps of a row or column in ascending
frame index, the order of the dense product.  The backward
(`_pallas_cut_bwd`) is the float32 transpose of the unrounded gather
`gather_f32`, with float32 weights on a float32 gradient.

On the card the forward is separable, as the TPU kernel is: a block owns
one sample and a band of output rows, stages the frame rows that the
band's taps reach as bf16 in shared memory, computes the rounded row pass
there and gathers the column taps from it.  The backward has each block
own a 32x32 tile of d_img and gather what the crops put there, walking
the samples in order after a pre-pass that finds which rows and columns
of each crop reach each tile: every pixel is written once, by one sum in
a fixed order, so no float32 atomics and the same bits on every run
(csrc/cutout.cu explains both designs).

`cutout()` launches the kernels for a CUDA image and runs `cutout_plain`
for a CPU image; anything else raises.
"""
from __future__ import annotations

import torch

from aphantasia_torch import kernels

_SIGNATURES = {
    "cutout_fwd": [kernels.PTR] * 7 + [kernels.INT] * 5 + [kernels.PTR],
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


def gather_f32(img, yidx, yw, xidx, xw):
    """The unrounded float32 cutout, whose transpose is the backward: rows
    first (gather + weight over the 4 y-taps -> [S,C,M,W]), then columns
    (gather + weight over the 4 x-taps).  Differentiable through
    autograd."""
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


def distinct_taps(idx, wts):
    """Each row's 4 taps in ascending index (a stable sort, so taps on one
    index keep their order), the first tap of each index carrying the
    float32 sum of that index's weights in tap order rounded once to bf16,
    the others weight 0: the rows of the TPU kernel's dense bf16 matrix.
    Returns (idx int64, weights float32 holding bf16 values)."""
    si, order = torch.sort(idx.long(), dim=-1, stable=True)
    sw = torch.gather(wts, -1, order)
    cols = []
    for k in range(4):
        acc = sw[..., k]
        for j in range(k + 1, 4):
            acc = acc + torch.where(si[..., j] == si[..., k], sw[..., j], 0.0)
        if k:
            acc = torch.where(si[..., k] == si[..., k - 1], 0.0, acc)
        cols.append(acc)
    return si, torch.stack(cols, -1).to(torch.bfloat16).float()


def rounded_fwd(img, yidx, yw, xidx, xw):
    """The TPU kernel's forward (module docstring), float32 [S,C,M,M]:
    each sum runs over a row's or column's distinct taps in ascending
    frame index, one term at a time."""
    c, h, w = img.shape
    s, m, _ = yidx.shape
    yi, wy = distinct_taps(*in_frame(yidx, yw, h))
    xi, wx = distinct_taps(*in_frame(xidx, xw, w))
    imgb = img.to(torch.bfloat16).float()
    tmp = 0.0
    for k in range(4):                                       # [C,S,M,W]
        tmp = tmp + imgb[:, yi[..., k]] * wy[None, ..., k, None]
    tmp = tmp.to(torch.bfloat16).float().transpose(0, 1)     # [S,C,M,W]
    out = 0.0
    for k in range(4):
        at = xi[:, None, None, :, k].expand(s, c, m, m)
        out = out + torch.gather(tmp, 3, at) * wx[:, None, None, :, k]
    return out


class _PlainFn(torch.autograd.Function):
    """`rounded_fwd` with the float32 transpose of `gather_f32` as its
    backward, as the TPU kernel's custom VJP pairs them; autograd through
    the bf16 casts would round the gradient."""

    @staticmethod
    def forward(ctx, img, yidx, yw, xidx, xw):
        ctx.save_for_backward(yidx, yw, xidx, xw)
        ctx.img_shape = tuple(img.shape)
        return rounded_fwd(img, yidx, yw, xidx, xw)

    @staticmethod
    def backward(ctx, g):
        taps = ctx.saved_tensors
        with torch.enable_grad():
            # gather_f32 is linear in the image: its gradient does not
            # depend on the point
            x = torch.zeros(ctx.img_shape, dtype=torch.float32,
                            device=g.device, requires_grad=True)
            (dimg,) = torch.autograd.grad(gather_f32(x, *taps), x, g)
        return dimg, None, None, None, None


def cutout_plain(img, yidx, yw, xidx, xw):
    """Plain PyTorch version of the kernel pair: `rounded_fwd` forward,
    `gather_f32`'s float32 transpose backward."""
    return _PlainFn.apply(img, yidx, yw, xidx, xw)


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
    """Launch the forward (the frame's bf16 copy, then the separable
    kernel; one count): float32 [S,C,M,M]."""
    img, yidx, yw, xidx, xw = _checked(img, yidx, yw, xidx, xw)
    c, h, w = img.shape
    s, m, _ = yidx.shape
    out = torch.empty((s, c, m, m), device=img.device, dtype=torch.float32)
    img16 = torch.empty((c, h, w), device=img.device, dtype=torch.bfloat16)
    img, yidx, yw, xidx, xw = (kernels.aligned(t)
                               for t in (img, yidx, yw, xidx, xw))
    lib = kernels.library("cutout", _SIGNATURES)
    code = lib.cutout_fwd(img.data_ptr(), img16.data_ptr(), yidx.data_ptr(),
                          yw.data_ptr(), xidx.data_ptr(), xw.data_ptr(),
                          out.data_ptr(), c, h, w, s, m,
                          kernels.stream_ptr(img))
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
