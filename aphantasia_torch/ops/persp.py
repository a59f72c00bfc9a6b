"""The exact perspective warp as a hand-written CUDA kernel pair
(csrc/persp.cu), with its plain PyTorch version beside it (counterpart of
aphantasia_tpu.ops.pallas_persp).

`perspective_warp(img, coef, flags, family)` warps [S,C,H,W] cutouts by
per-sample homography coeffs [S,8] with torchvision's semantics (bilinear,
zero padding, fill-0 mask; ops/perspective.py:homography_warp is the plain
version), and copies a sample whose flag is 0 unchanged.  It replaces the
Pallas kernels `_fwd_call` (pallas_persp.py:394) and `_bwd_call` (:439);
the backward is kernel B at the same coeffs.

The TPU kernel's window bounds (`k_fwd`/`k_bwd`/`k_rot_*`, the tiered
window bases, the 16-row alignment) and its fall-back to the XLA gather for
H % 16 != 0 exist for Mosaic's tiling; the CUDA kernels read their taps
directly and take any H and W, so none of them is ported.  `family` names
the coefficient family ("persp" or "rotate") as the JAX function does; the
kernels need no per-family bound, and the backward's one window assumption
(csrc/persp.cu) holds for both families.  Nor is `kernel_supported()`
ported: on the card the kernels build and launch, or the run raises.

CUDA tensors launch the kernels; CPU tensors run the plain version;
anything else raises.
"""
from __future__ import annotations

import math

import torch

from aphantasia_torch import kernels
from aphantasia_torch.ops.perspective import homography_warp

FAMILIES = ("persp", "rotate")

_SIGNATURES = {
    "persp_fwd": [kernels.PTR] * 4 + [kernels.INT] * 5 + [kernels.PTR],
    "persp_bwd": [kernels.PTR] * 4 + [kernels.INT] * 5 + [kernels.PTR],
}
_MAX_C = 4


def _prep(img, coef, flags):
    """float32 coeffs and int32 flags; flags derived from non-identity
    coeffs when omitted (as pallas_persp._prep does)."""
    coef = coef.float()
    if flags is None:
        ident = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0], dtype=torch.float32,
                             device=coef.device)
        flags = (torch.abs(coef - ident) > 1e-5).any(-1)
    return coef, flags.to(torch.int32)


def perspective_warp_plain(img, coef, flags):
    """Plain PyTorch version: `homography_warp` for flagged samples, the
    input itself for the others.  Differentiable in img."""
    keep = (flags == 0)[:, None, None, None]
    return torch.where(keep, img, homography_warp(img, coef))


def _checked(img, coef, flags):
    if img.dtype not in (torch.float32, torch.bfloat16) or img.ndim != 4:
        raise TypeError("perspective kernel takes a float32 or bf16 "
                        f"[S,C,H,W] tensor, got {img.dtype} "
                        f"{tuple(img.shape)}")
    s, c, h, w = img.shape
    if c > _MAX_C:
        raise ValueError(f"perspective kernel takes at most {_MAX_C} "
                         f"channels, got {c}")
    if coef.shape != (s, 8) or flags.shape != (s,):
        raise ValueError(f"coeffs {tuple(coef.shape)} / flags "
                         f"{tuple(flags.shape)} do not match {s} samples")
    if coef.device != img.device or flags.device != img.device:
        raise ValueError("perspective coeffs, flags and image must share a "
                         "device")
    # 16-byte aligned: the kernels copy and store in 16-byte vectors
    return kernels.aligned(img), coef.contiguous(), flags.contiguous()


def persp_fwd_kernel(img, coef, flags):
    """Launch kernel A: the warped [S,C,H,W] in img's dtype (a flag-0
    sample copied)."""
    img, coef, flags = _checked(img, coef, flags)
    s, c, h, w = img.shape
    out = torch.empty_like(img)
    lib = kernels.library("persp", _SIGNATURES)
    code = lib.persp_fwd(img.data_ptr(), coef.data_ptr(), flags.data_ptr(),
                         out.data_ptr(), s, c, h, w,
                         int(img.dtype == torch.bfloat16),
                         kernels.stream_ptr(img))
    kernels.check(lib, code, "persp_fwd")
    kernels.LAUNCHES["persp_fwd"] += 1
    return out


def persp_bwd_kernel(g, coef, flags):
    """Launch kernel B: d_img [S,C,H,W] for d_out `g`, in g's dtype (a
    flag-0 sample's g copied)."""
    g, coef, flags = _checked(g, coef, flags)
    s, c, h, w = g.shape
    dimg = torch.empty_like(g)
    lib = kernels.library("persp", _SIGNATURES)
    code = lib.persp_bwd(g.data_ptr(), coef.data_ptr(), flags.data_ptr(),
                         dimg.data_ptr(), s, c, h, w,
                         int(g.dtype == torch.bfloat16),
                         kernels.stream_ptr(g))
    kernels.check(lib, code, "persp_bwd")
    kernels.LAUNCHES["persp_bwd"] += 1
    return dimg


class _PerspFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coef, flags):
        ctx.save_for_backward(coef, flags)
        return persp_fwd_kernel(img, coef, flags)

    @staticmethod
    def backward(ctx, g):
        coef, flags = ctx.saved_tensors
        return persp_bwd_kernel(g, coef, flags), None, None


def perspective_warp(img, coef, flags=None, family: str = "persp"):
    """Exact torchvision homography of [S,C,H,W] by [S,8] coeffs; a sample
    with flag 0 is returned unchanged.  CUDA tensors launch the kernels;
    CPU tensors run `perspective_warp_plain`."""
    if family not in FAMILIES:
        raise ValueError(f"unknown warp family {family!r}")
    coef, flags = _prep(img, coef, flags)
    if img.is_cuda:
        return _PerspFn.apply(img, coef, flags)
    if img.device.type == "cpu":
        return perspective_warp_plain(img, coef, flags)
    raise RuntimeError(f"perspective_warp has no kernel for device "
                       f"{img.device}")


def default_budget(s: int, p: float = 0.2) -> int:
    """Compacted-batch size: Binomial(s, p) mean + 4.2 sigma + 2, rounded
    up to a multiple of 8 (pallas_persp.default_budget)."""
    b = int(math.ceil(p * s + 4.2 * math.sqrt(p * (1 - p) * s))) + 2
    return min(s, -(-b // 8) * 8)


def perspective_warp_compact(img, coef, flags, family: str = "persp",
                             budget: int | None = None):
    """`perspective_warp` with the drawn samples permuted to the front and
    only the first `budget` of them sent through the warp; the rest are
    copied.  More drawn samples than the budget warp the full batch.
    Equal to `perspective_warp` in value and gradient (the permutations are
    autograd's index_select).  No pipeline calls it (the JAX package keeps
    it off, augs.py:133-137); reading the drawn count syncs with the
    device."""
    if flags is None:
        return perspective_warp(img, coef, flags, family)
    s = img.shape[0]
    budget = default_budget(s) if budget is None else budget
    coef, flags = _prep(img, coef, flags)
    if budget >= s or int((flags > 0).sum()) > budget:
        return perspective_warp(img, coef, flags, family)
    order = torch.argsort(-flags, stable=True)
    inv = torch.argsort(order)
    permuted = img.index_select(0, order)
    head = order[:budget]
    warped = perspective_warp(permuted[:budget], coef.index_select(0, head),
                              flags.index_select(0, head), family)
    return torch.cat([warped, permuted[budget:]]).index_select(0, inv)
