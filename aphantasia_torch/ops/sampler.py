"""Batched random-cutout sampler (counterpart of aphantasia_tpu.ops.sampler).

Each step draws `count` crop boxes, then crops and bicubically resizes each
one to `modsize` (torch's `F.interpolate(mode='bicubic',
align_corners=True)` on the cropped view).  The draw (`sample_boxes`) and
the apply (`cut`) are separate, so tests can feed both frameworks the same
boxes.

Three apply paths, chosen in the JAX package's order:
* `use_pallas` (`--pallas`): the hand-written CUDA cutout kernel
  (ops/cutout.py), a direct 16-tap gather with a scatter backward;
* windowed (APHANTASIA_WIN_CUTOUT=1, `_win_eligible`): the hand-written
  CUDA windowed forward (ops/cutout_win.py) over each sample's tier
  window, with the dense transpose as backward (`_WinCut`);
* default: per-sample dense interpolation matrices, `cut[s] = Wy[s] @ img
  @ Wx[s]^T`, as two large batched matmuls (`_contract`).  On the card at
  a bf16 compute dtype the same function runs from the taps as a
  hand-written separable kernel pair (ops/cutout.py:`contract`), which
  builds no dense matrix; the CPU and a float32 compute dtype keep
  `_contract`.

The `overscan`/`overmax` tile padding is folded into the tap indices
through static index maps (ops/tile.py).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple

import torch

from aphantasia_torch.ops.cutout import w_first as _w_first
from aphantasia_torch.ops.cutout_win import (tier_plan, window_bases,
                                             windowed_cut_fwd)
from aphantasia_torch.ops.resize import resize_axis_taps
from aphantasia_torch.ops.tile import pad_maps


def _mm_f32(a, b):
    """a @ b (mm or bmm) summed and returned in float32 from operands in
    the compute dtype, as the JAX einsums' preferred_element_type=float32:
    cuBLAS writes float32 directly on the card; the CPU has no such kernel,
    so there the operands are widened (exact) first."""
    mm = torch.bmm if a.ndim == 3 else torch.mm
    if a.dtype == torch.float32:
        return mm(a, b)
    if a.is_cuda:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


def _contract_bwd(g, wy, wx, dt, w_first):
    """d_img [C,H,W] float32 of the dense contraction: the first product
    (d_tmp) in the compute dtype, the second summed in float32."""
    s, m, h = wy.shape
    w = wx.shape[2]
    c = g.shape[1]
    g = g.to(dt)
    if w_first:
        d_tmp = torch.einsum("scmn,smh->scnh", g, wy)          # [S,C,N,H]
        # d_img[c,h,w] = sum_{s,n} d_tmp[s,c,n,h] wx[s,n,w]
        a = d_tmp.permute(1, 3, 0, 2).reshape(c * h, s * m)
        return _mm_f32(a, wx.reshape(s * m, w)).reshape(c, h, w)
    d_tmp = torch.einsum("scmn,snw->scmw", g, wx)              # [S,C,M,W]
    # d_img[c,h,w] = sum_{s,m} wy[s,m,h] d_tmp[s,c,m,w]
    b = d_tmp.permute(0, 2, 1, 3).reshape(s * m, c * w)
    out = _mm_f32(wy.reshape(s * m, h).t(), b)                 # [H, C*W]
    return out.reshape(h, c, w).permute(1, 0, 2).contiguous()


class _Contract(torch.autograd.Function):
    """cuts[s,c,m,n] = wy[s,m,h] . img[c,h,w] . wx[s,n,w], with the first
    product of each direction (the forward intermediate, the backward's
    d_tmp) rounded to the compute dtype `dt` and the second summed and
    returned in float32, as the JAX einsums ask.  The contraction order
    keeps the materialized [S,C,M,*] intermediate at min(H, W): W is
    contracted first when H < W (the 1280x720 case), H first otherwise,
    unless `w_first` says which (the spatial cut contracts W first).
    wy/wx are constants of the random draw and get no gradient."""

    @staticmethod
    def forward(ctx, img, wy, wx, dt, w_first=None):
        ctx.save_for_backward(wy, wx)
        ctx.dt = dt
        ctx.w_first = (_w_first(img.shape[1], img.shape[2])
                       if w_first is None else w_first)
        x = img.to(dt)
        s, m, _ = wy.shape
        c = x.shape[0]
        if ctx.w_first:
            tmp = torch.einsum("snw,chw->scnh", wx, x)         # [S,C,N,H]
            b = tmp.reshape(s, c * m, -1).transpose(1, 2)      # [S,H,C*N]
            out = _mm_f32(wy, b).reshape(s, m, c, m)           # [S,M,C,N]
            return out.permute(0, 2, 1, 3).contiguous()
        tmp = torch.einsum("smh,chw->scmw", wy, x)             # [S,C,M,W]
        out = _mm_f32(tmp.reshape(s, c * m, -1), wx.transpose(1, 2))
        return out.reshape(s, c, m, m)

    @staticmethod
    def backward(ctx, g):
        wy, wx = ctx.saved_tensors
        return (_contract_bwd(g, wy, wx, ctx.dt, ctx.w_first),
                None, None, None, None)


def _contract(img, wy, wx, dt, w_first=None):
    return _Contract.apply(img, wy, wx, dt, w_first)


class _WinCut(torch.autograd.Function):
    """The windowed forward (ops/cutout_win.py) with the dense transpose
    as backward: the forward builds only the window-rebased weights, the
    backward rebuilds the dense matrices from the boxes, so neither rides
    from one to the other (aphantasia_tpu.ops.sampler._win_cut)."""

    @staticmethod
    def forward(ctx, img, sampler, dt, csize, offx, offy):
        boxes = Boxes(csize, offx, offy)
        ctx.save_for_backward(csize, offx, offy)
        ctx.sampler, ctx.dt = sampler, dt
        ctx.w_first = _w_first(img.shape[1], img.shape[2])
        h, w = sampler.frame_size
        bases = window_bases(boxes, h, w, sampler.modsize)
        wyw, wxt = sampler.weight_matrices_windowed(boxes, dtype=dt,
                                                    bases=bases)
        return windowed_cut_fwd(img.to(dt), boxes, wyw, wxt,
                                sampler.modsize, compute_dtype=dt,
                                bases=bases)

    @staticmethod
    def backward(ctx, g):
        boxes = Boxes(*ctx.saved_tensors)
        wy, wx = ctx.sampler.weight_matrices(boxes, dtype=ctx.dt)
        return (_contract_bwd(g, wy, wx, ctx.dt, ctx.w_first),
                None, None, None, None, None)


class Boxes(NamedTuple):
    """Per-sample crop boxes, in padded-frame coordinates (int32 [S])."""
    csize: torch.Tensor
    offx: torch.Tensor
    offy: torch.Tensor


@functools.lru_cache(maxsize=32)
def _index_maps(frame_size: tuple, padded_size: tuple, device):
    """The static padded->source maps of `pad_maps` as int32 tensors on a
    device, built once per device: a per-call host table is a pageable
    copy, which makes the host wait for the card and which a CUDA graph
    refuses.  Shared: never written to."""
    return tuple(torch.as_tensor(m, device=device)
                 for m in pad_maps(frame_size, padded_size, type="centr"))


def _take(table, idx):
    """table[idx] with the JAX package's gather semantics: a negative index
    counts from the end once, then every index is clamped into range (a
    crop larger than the padded frame draws such taps)."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx.long()]


def _dense_w(idx, wts, n, dtype):
    """[S,M,4] taps -> dense [S,M,n] by 4 compare-and-accumulate passes
    (taps repeat an index at crop borders, so they must add up)."""
    iota = torch.arange(n, dtype=torch.int32, device=idx.device)[None, None, :]
    acc = torch.zeros(idx.shape[:2] + (n,), dtype=torch.float32,
                      device=idx.device)
    for a in range(4):
        acc = acc + torch.where(iota == idx[:, :, a:a + 1],
                                wts[:, :, a:a + 1], 0.0)
    return acc.to(dtype)


def _dense_w_t(idx, wts, n, dtype):
    """Transposed build: [S,M,4] taps -> [S,n,M] (the windowed kernel's
    pre-transposed Wx operand)."""
    iota = torch.arange(n, dtype=torch.int32, device=idx.device)[None, :, None]
    acc = torch.zeros((idx.shape[0], n, idx.shape[1]), dtype=torch.float32,
                      device=idx.device)
    for a in range(4):
        acc = acc + torch.where(iota == idx[:, None, :, a],
                                wts[:, None, :, a], 0.0)
    return acc.to(dtype)


@dataclasses.dataclass(frozen=True)
class CutoutSampler:
    """Static sampling config.

    frame_size : (H, W) of the source frame
    count      : cutouts per step
    modsize    : CLIP input resolution (output side of every cutout)
    align      : 'uniform' | 'central' | 'overscan' | 'overmax'
    macro      : probability of a near-full-frame crop (0.9*min(H,W))
    chunk      : samples per matmul chunk (0 disables chunking)
    use_pallas : route `cut` through the hand-written cutout kernel
    """
    frame_size: tuple
    count: int
    modsize: int = 224
    align: str = "uniform"
    macro: float = 0.0
    chunk: int = 0
    use_pallas: bool = False

    @property
    def padded_size(self):
        h, w = self.frame_size
        if self.align == "overmax":
            return (2 * h, 2 * w)
        if "over" in self.align:
            return (int(1.5 * h), int(1.5 * w))
        return (h, w)

    @property
    def index_maps(self):
        """Static per-axis padded->source maps (numpy int32)."""
        return pad_maps(self.frame_size, self.padded_size, type="centr")

    # ---------------- the draw --------------------------------------------

    def sample_boxes(self, generator: torch.Generator) -> Boxes:
        """Draw `count` boxes on the generator's device."""
        h, w = self.frame_size
        hp, wp = self.padded_size
        s = self.count
        kw = dict(generator=generator, device=generator.device)
        rnd_size = torch.rand(s, **kw)
        if self.align == "central":  # normal around the center
            rnd_offx = torch.clamp(torch.randn(s, **kw) * 0.2 + 0.5, 0.0, 1.0)
            rnd_offy = torch.clamp(torch.randn(s, **kw) * 0.2 + 0.5, 0.0, 1.0)
        else:
            rnd_offx = torch.rand(s, **kw)
            rnd_offy = torch.rand(s, **kw)
        is_macro = torch.rand(s, **kw) < self.macro
        sz_max = float(min(h, w))   # min over the ORIGINAL dims
        sz_min = torch.where(is_macro, 0.9 * sz_max, float(self.modsize))
        csize = (rnd_size * (sz_max - sz_min) + sz_min).to(torch.int32)
        offx = (rnd_offx * (wp - csize).float()).to(torch.int32)
        offy = (rnd_offy * (hp - csize).float()).to(torch.int32)
        return Boxes(csize, offx, offy)

    # ---------------- interpolation taps ----------------------------------

    def tap_indices(self, boxes: Boxes):
        """Per-sample bicubic taps in source coordinates:
        (yidx, yw, xidx, xw), int32/float32 [S, modsize, 4]."""
        m = self.modsize
        yidx, yw = resize_axis_taps(m, boxes.csize, boxes.offy)
        xidx, xw = resize_axis_taps(m, boxes.csize, boxes.offx)
        if self.padded_size != tuple(self.frame_size):
            y_map, x_map = _index_maps(tuple(self.frame_size),
                                       self.padded_size, yidx.device)
            yidx = _take(y_map, yidx)
            xidx = _take(x_map, xidx)
        return yidx, yw, xidx, xw

    def weight_matrices(self, boxes: Boxes, dtype=torch.float32):
        """Dense interpolation matrices Wy [S,M,H], Wx [S,M,W]."""
        h, w = self.frame_size
        yidx, yw, xidx, xw = self.tap_indices(boxes)
        return _dense_w(yidx, yw, h, dtype), _dense_w(xidx, xw, w, dtype)

    def weight_matrices_windowed(self, boxes: Boxes, dtype=torch.float32,
                                 bases=None):
        """Window-rebased weights of the windowed forward: Wy [S,M,KHmax]
        with the y-taps rebased to the sample's row base, and Wx
        pre-transposed [S,KWmax,M] with the x-taps rebased to its column
        base (`bases`, ops/cutout_win.py:window_bases, computed here when
        not given).  The same taps as weight_matrices."""
        h, w = self.frame_size
        yidx, yw, xidx, xw = self.tap_indices(boxes)
        _, rb, cb = bases or window_bases(boxes, h, w, self.modsize)
        plan = tier_plan(h, w, self.modsize)
        wyw = _dense_w(yidx - rb[:, None, None], yw, plan[-1][1], dtype)
        wxt = _dense_w_t(xidx - cb[:, None, None], xw, plan[-1][2], dtype)
        return wyw, wxt

    # ---------------- the apply -------------------------------------------

    def _win_eligible(self, img, compute_dtype=None) -> bool:
        """The windowed path's gate, with the JAX package's conditions:
        APHANTASIA_WIN_CUTOUT=1 (read at each call), an exact frame (the
        overscan tile maps break the window rebasing), no chunking (the
        dense backward would rebuild the intermediate chunking bounds),
        and the frame in the compute dtype, padded to a multiple of 128
        columns, within 6.5 MB.  That budget is the TPU kernel's VMEM
        bound, not the card's; it is kept so that the same configurations
        take the same path in both packages."""
        if os.environ.get("APHANTASIA_WIN_CUTOUT") != "1":
            return False
        if self.padded_size != tuple(self.frame_size):
            return False
        if self.chunk and self.count > self.chunk:
            return False
        h, w = self.frame_size
        wp = -(-w // 128) * 128
        itemsize = (compute_dtype or torch.float32).itemsize
        return img.shape[0] * h * wp * itemsize <= 6_500_000

    def cut(self, img: torch.Tensor, boxes: Boxes,
            compute_dtype=None) -> torch.Tensor:
        """img [1,C,H,W] or [C,H,W] -> cutouts [S,C,M,M] float32."""
        if img.ndim == 4:
            img = img[0]
        if self.use_pallas:
            from aphantasia_torch.ops.cutout import cutout
            return cutout(img, *self.tap_indices(boxes))
        dt = compute_dtype or torch.float32
        if self._win_eligible(img, dt):
            return _WinCut.apply(img, self, dt, *boxes)
        if img.is_cuda and dt == torch.bfloat16:
            # every sample in one call: chunking changes no sample's result
            from aphantasia_torch.ops.cutout import contract
            return contract(img, *self.tap_indices(boxes))
        wy, wx = self.weight_matrices(boxes, dtype=dt)
        if self.chunk and self.count > self.chunk:
            b = self.chunk
            return torch.cat([_contract(img, wy[i:i + b], wx[i:i + b], dt)
                              for i in range(0, self.count, b)])
        return _contract(img, wy, wx, dt)
