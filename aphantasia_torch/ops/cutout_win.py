"""The windowed cutout forward as a hand-written CUDA kernel
(csrc/cutout_win.cu), with its plain PyTorch version beside it
(counterpart of aphantasia_tpu.ops.pallas_cutout_win).

    cut[s] = Wy_win[s] @ img[:, rb:rb+k_h, cb:cb+k_w] @ Wx_win[s]^T

Each sample reads only the window its bicubic taps can reach: three size
tiers `(k_h, k_w)` from `tier_plan`, chosen per sample by its drawn crop
size, with the row base floored to 16 and the column base to 128
(`window_bases`; `weight_matrices_windowed` in ops/sampler.py rebases
the taps to the same bases).  The intermediate is rounded to the compute dtype and the
output is float32, as in the TPU kernel (pallas_call at
pallas_cutout_win.py:128).  Columns at or past W read as zero.

`windowed_cut_fwd()` launches the kernel for a CUDA image and runs
`windowed_cut_fwd_plain` for a CPU image; anything else raises.  The
backward is the dense transpose (ops/sampler.py:_WinCut).
"""
from __future__ import annotations

import torch

from aphantasia_torch import kernels

_SIGNATURES = {
    "win_cut_fwd": [kernels.PTR] * 6 + [kernels.INT] * 11 + [kernels.PTR],
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tier_plan(h: int, w: int, modsize: int):
    """Static (csize_bound, k_h, k_w) tiers for an HxW frame: crop sizes up
    to 0.62, 0.82 and 1.0 of min(h, w); a window is the crop plus the 4
    bicubic taps plus the base alignment slack (rows 16, columns 128)."""
    cmax = min(h, w)
    bounds = [int(cmax * f) for f in (0.62, 0.82)] + [cmax]
    plan = []
    for b in bounds:
        k_h = min(_round_up(b + 4 + 15, 16), h)
        k_w = min(_round_up(b + 4 + 127, 128), _round_up(w, 128))
        plan.append((b, k_h, k_w))
    return plan


def _per_tier(tier, values):
    """values[tier] for a tier tensor and one Python int per tier, built
    with torch.where on the tier's device (no table copied from the host,
    so a CUDA graph can capture it)."""
    out = torch.full_like(tier, values[-1])
    for i, v in enumerate(values[:-1]):
        out = torch.where(tier == i, v, out)
    return out


def window_bases(boxes, h: int, w: int, modsize: int):
    """Per-sample (tier, rb, cb) int32 tensors for tier_plan(h, w, m):
    rb = clip(floor16(offy - 2), 0, h - k_h), cb = clip(floor128(offx -
    2), 0, ceil128(w) - k_w)."""
    plan = tier_plan(h, w, modsize)
    cs = boxes.csize
    tier = torch.zeros_like(cs)
    for i, (b, _, _) in enumerate(plan[:-1]):
        tier = torch.where(cs > b, i + 1, tier)
    wp = _round_up(w, 128)
    k_h = _per_tier(tier, [p[1] for p in plan])
    k_w = _per_tier(tier, [p[2] for p in plan])
    zero = torch.zeros_like(cs)
    rb = torch.div(boxes.offy - 2, 16, rounding_mode="floor") * 16
    rb = torch.minimum(torch.maximum(rb, zero), torch.clamp(h - k_h, min=0))
    cb = torch.div(boxes.offx - 2, 128, rounding_mode="floor") * 128
    cb = torch.minimum(torch.maximum(cb, zero), torch.clamp(wp - k_w, min=0))
    return tier.to(torch.int32), rb.to(torch.int32), cb.to(torch.int32)


def windowed_cut_fwd_plain(img, boxes, wyw, wxt, modsize: int,
                           compute_dtype=torch.bfloat16, bases=None):
    """Plain PyTorch version, tier by tier: gather the windows of the
    frame zero-padded to a multiple of 128 columns, then the two products
    summed in float32 from compute-dtype values, the first rounded to the
    compute dtype."""
    dt = compute_dtype
    c, h, w = img.shape
    s = boxes.csize.shape[0]
    m = modsize
    plan = tier_plan(h, w, m)
    tier, rb, cb = bases or window_bases(boxes, h, w, m)
    x = torch.nn.functional.pad(img.to(dt), (0, _round_up(w, 128) - w))
    out = torch.empty((s, c, m, m), dtype=torch.float32, device=img.device)
    for i, (_, k_h, k_w) in enumerate(plan):
        sel = torch.nonzero(tier == i).flatten()
        if sel.numel() == 0:
            continue
        rows = rb[sel].long()[:, None] + torch.arange(k_h, device=img.device)
        cols = cb[sel].long()[:, None] + torch.arange(k_w, device=img.device)
        win = x[:, rows[:, :, None], cols[:, None, :]]         # [C,n,Kh,Kw]
        t1 = torch.einsum("cnhw,nwm->nchm", win.float(),
                          wxt[sel, :k_w].float()).to(dt)
        out[sel] = torch.einsum("nmh,nchk->ncmk", wyw[sel, :, :k_h].float(),
                                t1.float())
    return out


def _geometry(bases, plan):
    """[S,4] int32 (rb, cb, k_h, k_w) per sample from window_bases'
    (tier, rb, cb), on their device."""
    tier, rb, cb = bases
    return torch.stack([rb, cb, _per_tier(tier, [p[1] for p in plan]),
                        _per_tier(tier, [p[2] for p in plan])],
                       1).contiguous()


def tma_pad(t):
    """`t` with its last axis zero-padded to a multiple of 8 elements, so
    that every row starts on a 16-byte boundary, as a TMA tensor map
    requires of its row strides; `t` itself when the axis is one already
    (no copy).  The zero columns read as the zeros past the frame's edge
    (or past a weight's last row) that the kernel reads anyway."""
    n = t.shape[-1]
    if n % 8 == 0:
        return t
    return torch.nn.functional.pad(t, (0, _round_up(n, 8) - n))


def windowed_cut_fwd_kernel(img, boxes, wyw, wxt, modsize: int,
                            compute_dtype=torch.bfloat16, bases=None,
                            t1=None):
    """Launch the kernel: float32 [S,C,M,M].  Both passes are one call,
    counted once under `win_cut_fwd`.  `bases` are window_bases(boxes,
    ...) when the caller has them; `t1` may hand in the intermediate's
    scratch ([S,C,KHmax,ceil8(M)] in the compute dtype), as the card tests
    do to show that the kernel reads none of it before writing it."""
    dt = compute_dtype
    if dt not in (torch.float32, torch.bfloat16) or img.ndim != 3:
        raise TypeError("windowed cutout kernel takes a [C,H,W] frame in "
                        f"bf16 or float32, got {img.dtype} {tuple(img.shape)}"
                        f" at {dt}")
    c, h, w = img.shape
    s = boxes.csize.shape[0]
    m = modsize
    plan = tier_plan(h, w, m)
    kh_max, kw_max = plan[-1][1], plan[-1][2]
    if (tuple(wyw.shape) != (s, m, kh_max)
            or tuple(wxt.shape) != (s, kw_max, m)):
        raise ValueError(f"windowed weights {tuple(wyw.shape)} / "
                         f"{tuple(wxt.shape)} != {(s, m, kh_max)} / "
                         f"{(s, kw_max, m)}")
    for t in (wyw, wxt, *boxes):
        if t.device != img.device:
            raise ValueError("windowed cutout: frame, boxes and weights "
                             "must share a device")
    if bases is None:
        bases = window_bases(boxes, h, w, m)
    geo = _geometry(bases, plan)
    img, wyw, wxt = (t.to(dt) for t in (img, wyw, wxt))
    if dt == torch.bfloat16:
        # TMA: 16-byte row strides, 16-byte aligned bases
        img, wyw, wxt = (kernels.aligned(tma_pad(t)) for t in (img, wyw, wxt))
    else:
        # the float32 tiles read 8 elements a load
        img, wyw, wxt = (kernels.aligned(t) for t in (img, wyw, wxt))
    mp = wxt.shape[-1]
    if t1 is None:
        t1 = torch.empty((s, c, kh_max, mp), dtype=dt, device=img.device)
    elif (tuple(t1.shape) != (s, c, kh_max, mp) or t1.dtype != dt
          or not t1.is_contiguous() or t1.data_ptr() % 16):
        raise ValueError(f"windowed cutout scratch {t1.dtype} "
                         f"{tuple(t1.shape)} != {dt} {(s, c, kh_max, mp)}")
    out = torch.empty((s, c, m, m), dtype=torch.float32, device=img.device)
    lib = kernels.library("cutout_win", _SIGNATURES)
    code = lib.win_cut_fwd(img.data_ptr(), geo.data_ptr(), wyw.data_ptr(),
                           wxt.data_ptr(), t1.data_ptr(), out.data_ptr(),
                           c, h, w, img.shape[-1], s, m, mp, kh_max,
                           wyw.shape[-1], kw_max, int(dt == torch.bfloat16),
                           kernels.stream_ptr(img))
    kernels.check(lib, code, "win_cut_fwd")
    kernels.LAUNCHES["win_cut_fwd"] += 1
    return out


def windowed_cut_fwd(img, boxes, wyw, wxt, modsize: int,
                     compute_dtype=torch.bfloat16, bases=None):
    """img [C,H,W]; boxes (csize, offx, offy) int32 [S]; window-rebased
    weights wyw [S,M,KHmax] and pre-transposed wxt [S,KWmax,M] -> cuts
    [S,C,M,M] float32.  `bases`: window_bases(boxes, H, W, M), when the
    caller has them already.  CUDA tensors launch the kernel; CPU tensors
    run `windowed_cut_fwd_plain`."""
    if img.is_cuda:
        return windowed_cut_fwd_kernel(img, boxes, wyw, wxt, modsize,
                                       compute_dtype, bases)
    if img.device.type == "cpu":
        return windowed_cut_fwd_plain(img, boxes, wyw, wxt, modsize,
                                      compute_dtype, bases)
    raise RuntimeError(f"windowed cutout has no kernel for device "
                       f"{img.device}")
