"""Batched random-cutout sampler (counterpart of aphantasia_tpu.ops.sampler).

Each step draws `count` crop boxes, then crops and bicubically resizes each
one to `modsize` (torch's `F.interpolate(mode='bicubic',
align_corners=True)` on the cropped view).  The draw (`sample_boxes`) and
the apply (`cut`) are separate, so tests can feed both frameworks the same
boxes.

Two apply paths, as in the JAX package:
* default: per-sample dense interpolation matrices, `cut[s] = Wy[s] @ img
  @ Wx[s]^T`, as two large batched matmuls (`_contract`);
* `use_pallas` (`--pallas`): the hand-written CUDA cutout kernel
  (ops/cutout.py), a direct 16-tap gather with a scatter backward.

The `overscan`/`overmax` tile padding is folded into the tap indices
through static index maps (ops/tile.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from aphantasia_torch.ops.resize import resize_axis_taps
from aphantasia_torch.ops.tile import pad_maps


class _Contract(torch.autograd.Function):
    """cuts[s,c,m,n] = wy[s,m,h] . img[c,h,w] . wx[s,n,w], with the
    intermediate and the backward chain held in the compute dtype `dt` and
    float32 output.  The contraction order keeps the materialized
    [S,C,M,*] intermediate at min(H, W): W is contracted first when H < W
    (the 1280x720 case), H first otherwise.  wy/wx are constants of the
    random draw and get no gradient."""

    @staticmethod
    def forward(ctx, img, wy, wx, dt):
        ctx.save_for_backward(wy, wx)
        ctx.dt = dt
        ctx.w_first = img.shape[1] < img.shape[2]
        x = img.to(dt)
        if ctx.w_first:
            tmp = torch.einsum("snw,chw->scnh", wx, x)
            return torch.einsum("smh,scnh->scmn", wy, tmp).float()
        tmp = torch.einsum("smh,chw->scmw", wy, x)
        return torch.einsum("scmw,snw->scmn", tmp, wx).float()

    @staticmethod
    def backward(ctx, g):
        wy, wx = ctx.saved_tensors
        g = g.to(ctx.dt)
        if ctx.w_first:
            d_tmp = torch.einsum("scmn,smh->scnh", g, wy)
            d_img = torch.einsum("snw,scnh->chw", wx, d_tmp)
        else:
            d_tmp = torch.einsum("scmn,snw->scmw", g, wx)
            d_img = torch.einsum("smh,scmw->chw", wy, d_tmp)
        return d_img.float(), None, None, None


def _contract(img, wy, wx, dt):
    return _Contract.apply(img, wy, wx, dt)


class Boxes(NamedTuple):
    """Per-sample crop boxes, in padded-frame coordinates (int32 [S])."""
    csize: torch.Tensor
    offx: torch.Tensor
    offy: torch.Tensor


def _take(table, idx):
    """table[idx] with the JAX package's gather semantics: a negative index
    counts from the end once, then every index is clamped into range (a
    crop larger than the padded frame draws such taps)."""
    table = torch.as_tensor(table, device=idx.device)
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
            y_map, x_map = self.index_maps
            yidx = _take(y_map, yidx)
            xidx = _take(x_map, xidx)
        return yidx, yw, xidx, xw

    def weight_matrices(self, boxes: Boxes, dtype=torch.float32):
        """Dense interpolation matrices Wy [S,M,H], Wx [S,M,W]."""
        h, w = self.frame_size
        yidx, yw, xidx, xw = self.tap_indices(boxes)
        return _dense_w(yidx, yw, h, dtype), _dense_w(xidx, xw, w, dtype)

    # ---------------- the apply -------------------------------------------

    def cut(self, img: torch.Tensor, boxes: Boxes,
            compute_dtype=None) -> torch.Tensor:
        """img [1,C,H,W] or [C,H,W] -> cutouts [S,C,M,M] float32."""
        if img.ndim == 4:
            img = img[0]
        if self.use_pallas:
            from aphantasia_torch.ops.cutout import cutout
            return cutout(img, *self.tap_indices(boxes))
        dt = compute_dtype or torch.float32
        wy, wx = self.weight_matrices(boxes, dtype=dt)
        if self.chunk and self.count > self.chunk:
            b = self.chunk
            return torch.cat([_contract(img, wy[i:i + b], wx[i:i + b], dt)
                              for i in range(0, self.count, b)])
        return _contract(img, wy, wx, dt)
