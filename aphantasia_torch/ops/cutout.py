"""The cutout crop-and-resize as a hand-written CUDA kernel pair
(csrc/cutout.cu), with its plain PyTorch version beside it.

    out[s,c,m,n] = sum_a sum_b yw[s,m,a] * xw[s,n,b]
                   * img[c, yidx[s,m,a], xidx[s,n,b]]

Replaces the Pallas kernels of aphantasia_tpu/ops/pallas_cutout.py:
`_pallas_cut_fwd` (pallas_call at :109) and `_pallas_cut_bwd` (:139).  The
TPU kernel builds dense Wy/Wx per sample and runs two MXU matmuls with the
frame pinned in VMEM; here each output is a direct 16-tap gather, so no
dense matrix and no [S,C,M,W] intermediate exist.  The backward scatters
`yw*xw*g` into d_img with float32 atomics (csrc/cutout.cu explains the
bound and the order).

`cutout()` launches the kernels for a CUDA image and runs `cutout_plain`
for a CPU image; anything else raises.
"""
from __future__ import annotations

import torch

from aphantasia_torch import kernels

_SIGNATURES = {
    "cutout_fwd": [kernels.PTR] * 6 + [kernels.INT] * 5 + [kernels.PTR],
    "cutout_bwd": [kernels.PTR] * 6 + [kernels.INT] * 5 + [kernels.PTR],
}


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
    """Launch the backward kernel: float32 d_img [C,H,W]."""
    c, h, w = img_shape
    g = g.float().contiguous()
    s, m, _ = yidx.shape
    if g.shape != (s, c, m, m):
        raise ValueError(f"cutout grad shape {tuple(g.shape)} != "
                         f"{(s, c, m, m)}")
    dimg = torch.zeros((c, h, w), device=g.device, dtype=torch.float32)
    _, yidx, yw, xidx, xw = _checked(dimg, yidx, yw, xidx, xw)
    lib = kernels.library("cutout", _SIGNATURES)
    code = lib.cutout_bwd(g.data_ptr(), yidx.data_ptr(), yw.data_ptr(),
                          xidx.data_ptr(), xw.data_ptr(), dimg.data_ptr(),
                          c, h, w, s, m, kernels.stream_ptr(g))
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
