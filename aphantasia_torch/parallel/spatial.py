"""Spatially sharded canvases on torch.distributed (counterpart of
aphantasia_tpu.parallel.spatial): the FFT spectrum, its irfft2 decode
and the cutout contraction spread over the mesh's 'spatial' axis, so no
rank holds the whole image in the training step.

  spectrum [1,3,H,Wf',2]   rank s holds the columns [s, s+1) * Wf'/n
   -> ifft along H          local (each rank has every row of its columns)
   -> all-to-all            column shards -> row shards (the FFT transpose)
   -> irfft along W         local -> image rows [1,3,H/n,W]
   -> color head            elementwise, local
   -> cutout contraction    W contracted locally (wx whole), then the
                            rank's rows of wy; one all-reduce of the
                            cut-sized [S,C,M,M] partials

ifft over H then irfft over W is irfft2 (ortho applies 1/sqrt per axis).
Wf = W//2+1 is padded with zero columns to Wf' % n == 0 and the pad is
dropped before the irfft; the decay scale is zero on the pad columns, so
they get no gradient and stay zero under Adam.  `SpatialRGB` shards the
pixels by rows (padded to a container height H' % n == 0);
`parallel/spatial_dwt.py:SpatialDWT` the finest levels of the wavelet
pyramid.  The LPIPS sync term takes the whole frame as the step's rows
gathered (`gather`, differentiable), where JAX's `image` decodes it again
with the same shift: the same values, one decode fewer.

Gradients.  Every rank of a spatial group computes the same loss from
the summed cuts, so the cuts' all-reduce passes the whole cotangent back
unchanged (`_SpatialSum` with `sum_back=False`; a backward that summed
it again would count it n times); so do the all-reduces of the
sharpness and anchor moments, which feed the loss directly.  The decode's
contrast moments are used on each rank's own rows, so each rank's
cotangent holds its rows' share, and their backward sums over the group
(`sum_back=True`).  The all-to-all's backward is the inverse all-to-all;
a halo exchange's (`_Permute`) sends the cotangent back to the sender;
the row gather's keeps the rank's own rows.  A data axis composes as in
`step.py`: each data rank cuts its rows of the cutouts, the encodings
are gathered, the image-side terms count their gradient on data rank 0
(`mesh.replicated`) and the params' gradients are summed over the data
axis.  Every collective adds one to `kernels.LAUNCHES` where it launches
(`sp_all_reduce`, `sp_all_to_all`, `sp_all_gather`, `sp_halo`), so a
captured group counts them per replay.  The halo exchange runs only with
n > 1.

The frame warp (`spatial_frame_warp`) decodes the raw spectrum to rows,
gathers the whole frame once, warps it with the dense `frame_transform`
and `grid_warp`, keeps the rank's rows and encodes them back; the JAX
package writes these transforms as matmul-DFTs for its TPU and XLA-CPU,
the port uses torch.fft (cuFFT on the card), as its dense decode does.

Builders: `build_spatial_train_step`, `build_spatial_train_loop_frames`
(a `step.FrameLoop`), `build_spatial_frame_step` (a `step.FrameStep`)
and `build_spatial_depth_helpers`, on `step.py`'s machinery, so that on
the card a spatial group is captured into a CUDA graph and replayed as a
dense one is.  The cut is the compute-dtype einsum of the JAX package
(`--pallas` has no effect under a spatial axis, as in JAX).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from aphantasia_torch import kernels
from aphantasia_torch.models.clip.model import encode_image
from aphantasia_torch.models.lpips import lpips_apply
from aphantasia_torch.ops.augs import get_transform
from aphantasia_torch.ops.losses import aesthetic_apply, sim_func
from aphantasia_torch.ops.optim import leaves
from aphantasia_torch.ops.resize import resize_bicubic
from aphantasia_torch.ops.sampler import _contract
from aphantasia_torch.params.color import to_valid_rgb
from aphantasia_torch.params.fft import _imag_keep, fft_scale
from aphantasia_torch.parallel.mesh import (gather_rows, reduce_grads,
                                            replicated, shard_batch)


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_spectrum(params: torch.Tensor, n_shards: int) -> torch.Tensor:
    """[...,H,Wf,2] -> [...,H,Wf',2] with zero columns, Wf' % n == 0."""
    wf = params.shape[-2]
    wf_p = _pad_to(wf, n_shards)
    return params if wf_p == wf else F.pad(params, (0, 0, 0, wf_p - wf))


def unpad_spectrum(params: torch.Tensor, w: int) -> torch.Tensor:
    """A padded spectrum's canonical Wf = w//2+1 columns (the reference
    layout of the `.pt` snapshots)."""
    return params[..., : w // 2 + 1, :]


@functools.lru_cache(maxsize=8)
def _padded_scale(h: int, w: int, decay: float, n_shards: int) -> np.ndarray:
    """fft_scale [1,1,h,wf,1] with zero pad columns to Wf'."""
    scale = fft_scale(h, w, decay)
    wf = scale.shape[3]
    wf_p = _pad_to(wf, n_shards)
    if wf_p != wf:
        scale = np.pad(scale, ((0, 0),) * 3 + ((0, wf_p - wf), (0, 0)))
    return scale


@functools.lru_cache(maxsize=16)
def _scale_cols(h: int, w: int, decay: float, n: int, idx: int, device):
    """Rank idx's columns of `_padded_scale`, once per device.  Shared:
    never written to."""
    scale = _padded_scale(h, w, decay, n)
    k = scale.shape[3] // n
    return torch.as_tensor(np.ascontiguousarray(
        scale[:, :, :, idx * k:(idx + 1) * k]), device=device)


# ------------------------------------------------------------- collectives

def _count(name: str) -> None:
    kernels.LAUNCHES[name] += 1


def _all_gather(x, group, n: int) -> list:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _SpatialSum(torch.autograd.Function):
    """The sum over the spatial group.  Backward: the identity where the
    sum feeds the same computation on every rank (module docstring), or
    with `sum_back` the cotangents summed over the group."""

    @staticmethod
    def forward(ctx, x, group, sum_back: bool):
        ctx.group, ctx.sum_back = group, sum_back
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        _count("sp_all_reduce")
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_back:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            _count("sp_all_reduce")
        return g, None, None


def _a2a(x, group, n: int, split: int, concat: int):
    """Split `x` into n chunks along `split`, send chunk j to rank j, and
    concatenate the chunks received, rank by rank, along `concat`."""
    parts = torch.stack(x.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    _count("sp_all_to_all")
    return torch.cat(out.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    """`_a2a`, with the inverse all-to-all as its backward."""

    @staticmethod
    def forward(ctx, x, group, n: int, split: int, concat: int):
        ctx.args = (group, n, concat, split)
        return _a2a(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None, None


class _Permute(torch.autograd.Function):
    """A ppermute: rank s returns the piece `x` of rank src[s], or zeros
    where src[s] is None; written as an all-gather of the pieces (they
    are a few rows).  Backward: each rank's cotangent goes back to the
    rank it came from, and a piece that no rank took gets zeros."""

    @staticmethod
    def forward(ctx, x, group, n: int, me: int, src: tuple):
        ctx.args = (group, n, me, src)
        parts = _all_gather(x, group, n)
        _count("sp_halo")
        return (torch.zeros_like(x) if src[me] is None
                else parts[src[me]].clone())

    @staticmethod
    def backward(ctx, g):
        group, n, me, src = ctx.args
        parts = _all_gather(g, group, n)
        _count("sp_halo")
        out = torch.zeros_like(g)
        for r in range(n):
            if src[r] == me:
                out = out + parts[r]
        return out, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows [..., hloc, W] concatenated along the rows, whole
    on each rank; every rank computes the same from them, so the backward
    keeps the rank's own rows."""

    @staticmethod
    def forward(ctx, x, group, n: int, me: int):
        ctx.me, ctx.hloc = me, x.shape[-2]
        out = torch.cat(_all_gather(x, group, n), dim=-2)
        _count("sp_all_gather")
        return out

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(-2, ctx.me * ctx.hloc, ctx.hloc).contiguous(),
                None, None, None)


# ------------------------------------------------------------------ canvases

class SpatialCanvas:
    """Base of the sharded parameterizers (`SpatialFFT`, `SpatialRGB`,
    `spatial_dwt.SpatialDWT`): the image lives as `h_container // n` rows
    a rank (`h_container` is H, or H padded for RGB and DWT), and the
    cutout contraction, sharpness, anchors, render and row gathers are
    shared.  Subclasses give `shard`, `full` (the canonical params,
    gathered), `decode_rows` and, for the frame warp, `raw_rows` and
    `from_rows`; `draw_shape` is the shape of the spectrum whose noise
    the step draws (None: no shift)."""

    draw_shape = None

    def _init_mesh(self, size, colors, mesh):
        self.size = tuple(size)
        self.colors = colors
        self.mesh = mesh
        self.n = mesh.size("spatial")
        self.idx = mesh.coord("spatial")
        self.group = mesh.spatial_group

    @property
    def hloc(self) -> int:
        return self.h_container // self.n

    def _real(self, x, n_real: int):
        """`x` [..., tloc, W] (the rank's rows of a container) with the
        rows at or past global row `n_real` zeroed."""
        tloc = x.shape[-2]
        row = self.idx * tloc + torch.arange(tloc, device=x.device)
        return x * (row < n_real).to(x.dtype)[:, None]

    def sum(self, x, sum_back: bool = False):
        return _SpatialSum.apply(x, self.group, sum_back)

    def normalize(self, img):
        """img / std over the whole image (Bessel), from two sums over the
        group; the pad rows must hold zeros."""
        h, w = self.size
        s = self.sum(torch.stack([img.sum(), (img * img).sum()]), True)
        cnt = 3 * h * w
        var = (s[1] - s[0] * s[0] / cnt) / (cnt - 1)
        return img * torch.rsqrt(var + 1e-20)

    def pad_wy(self, wy):
        """[S,M,H] row weights padded to the container height (zero rows,
        like the container's pad rows, so the contraction is exact)."""
        pad = self.h_container - wy.shape[-1]
        return F.pad(wy, (0, pad)) if pad else wy

    def my_rows(self, x):
        """The rank's rows of a container-high [..., H', W] tensor."""
        return x.narrow(-2, self.idx * self.hloc, self.hloc)

    def gather(self, rows):
        """The rows of every rank, whole and cropped to H (differentiable:
        the backward keeps the rank's own rows)."""
        full = _GatherRows.apply(rows, self.group, self.n, self.idx)
        return full[..., :self.size[0], :]

    def local_shift(self, shift):
        """The rank's part of a drawn noise shift."""
        return None

    def reduce_grads(self, grads) -> None:
        """Sum the gradients of the leaves every rank holds whole over the
        group (none here)."""

    def rgb_rows(self, params, shift=None, contrast: float = 1.0):
        return to_valid_rgb(self.decode_rows(params, shift) * contrast,
                            colors=self.colors)

    def cut(self, rgb, wy, wx, dt):
        """Cuts [S,C,M,M] float32 of the rows `rgb` [1,3,hloc,W] with the
        container-high `wy` [S,M,H'] and `wx` [S,M,W]: W contracted first,
        then the rank's rows, summed over the group."""
        wy = wy.narrow(-1, self.idx * self.hloc, self.hloc)
        part = _contract(rgb[0], wy, wx, dt, True)
        return self.sum(part)

    def sharp(self, img):
        """'naiv' sharpness (ops/losses.py:derivat) of the rows `img`: the
        x differences are row-local, the pair across a rank boundary takes
        the first row of the next rank (`_Permute`, cyclic), and the pairs
        that reach a pad row, and the wrap pair, are masked."""
        h, w = self.size
        n, hloc, idx = self.n, self.hloc, self.idx
        dx_sum = (img[..., 1:] - img[..., :-1]).abs().sum()
        dy = (img[:, :, 1:, :] - img[:, :, :-1, :]).abs()
        if self.h_container != h:
            # pad rows are a constant after the color head: keep the pairs
            # whose lower row is a real row
            row1 = idx * hloc + 1 + torch.arange(hloc - 1, device=img.device)
            dy = dy * (row1 < h).to(dy.dtype)[None, None, :, None]
        dy_sum = dy.sum()
        if n > 1:
            halo = _Permute.apply(img[:, :, :1, :].contiguous(), self.group,
                                  n, idx, tuple((i + 1) % n for i in range(n)))
            ok = float(idx < n - 1 and (idx + 1) * hloc < h)
            # multiplied, not skipped: every rank runs the halo's backward
            dy_sum = dy_sum + ok * (halo - img[:, :, -1:, :]).abs().sum()
        s = self.sum(torch.stack([dx_sum, dy_sum]))
        return 0.5 * (s[0] / (3 * h * (w - 1)) + s[1] / (3 * (h - 1) * w))

    def anchors(self, img):
        """Per-channel mean and std (Bessel) of the RGB rows, from two
        [3]-sized sums; the pad rows are masked out."""
        h, w = self.size
        if self.h_container != h:
            img = self._real(img, h)
        s = self.sum(torch.stack([img.sum(dim=(0, 2, 3)),
                                  (img * img).sum(dim=(0, 2, 3))]))
        cnt = h * w
        mean = s[0] / cnt
        var = (s[1] - s[0] * s[0] / cnt) / (cnt - 1)
        return mean, torch.sqrt(var)

    @torch.no_grad()
    def render(self, params, contrast: float = 1.0):
        """The whole frame [1,3,H,W] in RGB, on every rank."""
        return self.gather(self.rgb_rows(params, contrast=contrast))


class SpatialFFT(SpatialCanvas):
    """The FFT parameterizer over the spatial axis: the spectrum's columns
    sharded, its decode as in the module docstring (counterpart of JAX
    `SpatialFFT`).  `shard(params)` takes a canonical or padded spectrum
    to the rank's columns, `full(params)` gathers them back unpadded."""

    def __init__(self, size, decay_power: float, colors: float, mesh):
        self._init_mesh(size, colors, mesh)
        self.decay_power = decay_power
        h, w = self.size
        if h % self.n:
            raise ValueError(f"H={h} must divide the spatial axis ({self.n})")
        self.h_container = h
        self.wf = w // 2 + 1
        self.wf_p = _pad_to(self.wf, self.n)
        self.wloc = self.wf_p // self.n
        self.draw_shape = (1, 3, h, self.wf_p, 2)

    def init(self, generator: torch.Generator, sd: float = 0.01):
        """sd * randn over the padded spectrum, pad columns zeroed, as JAX
        draws it; the rank's columns."""
        p = sd * torch.randn(self.draw_shape, generator=generator,
                             device=generator.device, dtype=torch.float32)
        p[..., self.wf:, :] = 0.0
        return self.shard(p)

    def shard(self, params):
        p = pad_spectrum(torch.as_tensor(params, dtype=torch.float32),
                         self.n)
        return p[..., self.idx * self.wloc:(self.idx + 1) * self.wloc,
                 :].contiguous()

    @torch.no_grad()
    def full(self, params):
        out = torch.cat(_all_gather(params, self.group, self.n), dim=-2)
        _count("sp_all_gather")
        return unpad_spectrum(out, self.size[1])

    def local_shift(self, shift):
        if shift is None:
            return None
        return shift[..., self.idx * self.wloc:(self.idx + 1) * self.wloc, :]

    def _scale(self, device):
        h, w = self.size
        return _scale_cols(h, w, self.decay_power, self.n, self.idx,
                           str(device))

    def _rows(self, spec_ri, grad: bool):
        """Raw ortho irfft2 of the rank's columns [1,3,H,Wf'/n,2] -> image
        rows [1,3,H/n,W]: ifft over H, the all-to-all, the pad dropped and
        the DC and Nyquist imaginary parts zeroed, irfft over W."""
        w = self.size[1]
        spec = torch.complex(spec_ri[..., 0], spec_ri[..., 1])
        spec = torch.view_as_real(torch.fft.ifft(spec, dim=2, norm="ortho"))
        if grad:
            spec = _AllToAll.apply(spec, self.group, self.n, 2, 3)
        else:
            spec = _a2a(spec, self.group, self.n, 2, 3)
        spec = spec[:, :, :, :self.wf]
        z = torch.complex(spec[..., 0], spec[..., 1]
                          * _imag_keep(self.wf, w, spec.device))
        return torch.fft.irfft(z, n=w, dim=3, norm="ortho")

    def decode_rows(self, params, shift=None):
        p = params if shift is None else params + shift
        return self.normalize(self._rows(self._scale(params.device) * p,
                                         True))

    def raw_rows(self, params):
        """The raw spectrum's image rows (no decay scale, no contrast):
        the distributed `spectrum_to_image`."""
        return self._rows(params, False)

    def from_rows(self, rows):
        """Image rows [1,3,H/n,W] -> the rank's raw spectrum columns, pad
        columns zero: the distributed `image_to_spectrum`."""
        spec = torch.view_as_real(torch.fft.rfft(rows, dim=3, norm="ortho"))
        spec = F.pad(spec, (0, 0, 0, self.wf_p - self.wf))
        spec = _a2a(spec, self.group, self.n, 3, 2)
        spec = torch.fft.fft(torch.complex(spec[..., 0], spec[..., 1]), dim=2,
                             norm="ortho")
        return torch.view_as_real(spec).contiguous()


class SpatialRGB(SpatialCanvas):
    """The raw-pixel parameterizer (params/pixel.py) sharded by rows,
    padded to the container height H' = H rounded up to n (counterpart of
    JAX `SpatialRGB`): the decode is the contrast rescale, the global std
    from two sums over the group, or /3.3 with `fixcontrast`."""

    def __init__(self, size, colors: float, mesh, fixcontrast: bool = False):
        self._init_mesh(size, colors, mesh)
        self.fixcontrast = fixcontrast
        self.h_container = _pad_to(self.size[0], self.n)

    def shard(self, params):
        p = torch.as_tensor(params, dtype=torch.float32)
        pad = self.h_container - p.shape[-2]
        if pad:
            p = F.pad(p, (0, 0, 0, pad))
        return self.my_rows(p).contiguous()

    @torch.no_grad()
    def full(self, params):
        return self.gather(params)

    def decode_rows(self, params, shift=None):
        del shift  # the pixel decode takes no shift
        if self.h_container != self.size[0]:
            # pad rows masked before the sums: otherwise the std's
            # gradient reaches them and Adam walks them off zero
            params = self._real(params, self.size[0])
        if self.fixcontrast:
            return params / 3.3
        return self.normalize(params)

    def raw_rows(self, params):
        return params

    def from_rows(self, rows):
        return rows


def global_range(x, spar) -> torch.Tensor:
    """max(x) - min(x) over every rank of the spatial group (the pads
    included, as in JAX)."""
    mx, mn = x.max().reshape(1).clone(), x.min().reshape(1).clone()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=spar.group)
    dist.all_reduce(mn, op=dist.ReduceOp.MIN, group=spar.group)
    _count("sp_all_reduce")
    _count("sp_all_reduce")
    return (mx - mn)[0]


# ------------------------------------------------------------- frame warp

def spatial_frame_warp(fs, spar, params, motion, depth_map=None):
    """The illustrip frame advance on the sharded state: raw rows, one
    gather of the frame, `fs.warp_frame` (the dense depth warp and
    `frame_transform`), the rank's rows back, encoded.  No gradient."""
    with torch.no_grad():
        full = spar.gather(spar.raw_rows(params))
        full = fs.warp_frame(full, motion, depth_map)
        pad = spar.h_container - full.shape[-2]
        if pad:
            full = F.pad(full, (0, 0, 0, pad))
        return spar.from_rows(spar.my_rows(full).contiguous())


def spatial_depth_preview(spar, params):
    """The DA-V2-sized preview of the sharded frame state: raw rows, one
    gather, the dense `_depth_preview` on every rank."""
    from aphantasia_torch.step import _depth_preview
    with torch.no_grad():
        full = spar.gather(spar.raw_rows(params))
        return _depth_preview(full, spar.size, spar.colors)


# ------------------------------------------------------------------ the step

def build_spatial_loss_fn(spar, sampler, clip_cfg, settings):
    """loss_fn(gen_params, clip_params, aest_params, lpips_bundle, prompts,
    prev_enc, draws, step_i) -> (loss, out_enc detached) over the sharded
    canvas (JAX `_spatial_grad_fn`), in the dense loss's signature:
    `gen_params` are the rank's shard; `draws` are the dense step's
    StepDraws, the noise shift drawn at `spar.draw_shape`.  Its terms, in
    JAX's order: sharpness ('naiv'), the aesthetic head, the prompt
    groups, the LPIPS sync on the gathered frame, the RGB anchors,
    enforce (the same decode) and expand."""
    mesh = spar.mesh
    transform = get_transform(settings.transform, settings.persp)
    dt = settings.clip_dtype
    n = sampler.count
    data = mesh.size("data") > 1
    local = sampler
    if data:
        rows = mesh.rows(n)
        local = dataclasses.replace(sampler, count=rows.stop - rows.start)

    def encode_cuts(clip_params, cut_draws, rgb):
        if data:
            cut_draws = shard_batch(cut_draws, mesh, n)
        wy, wx = local.weight_matrices(cut_draws.boxes, dtype=dt)
        cuts = spar.cut(rgb, spar.pad_wy(wy), wx, dt)
        cuts = transform.apply(cut_draws.aug, cuts.to(dt))
        enc = encode_image(clip_params, clip_cfg, cuts, dtype=dt).float()
        return gather_rows(enc, mesh, n) if data else enc

    def loss_fn(gen_params, clip_params, aest_params, lpips_bundle, prompts,
                prev_enc, draws, step_i):
        from aphantasia_torch.step import _step_tensor
        shift = spar.local_shift(draws.shift)
        rgb = spar.rgb_rows(gen_params, shift)
        out_enc = encode_cuts(clip_params, draws.cuts, rgb)
        rgb_r = replicated(rgb, mesh)     # the image-side terms' input
        dev = rgb.device
        loss = torch.zeros((), device=dev)
        if settings.sharp != 0:
            loss = loss - settings.sharp * spar.sharp(rgb_r)
        if settings.aest != 0 and aest_params is not None:
            loss = loss - 0.001 * settings.aest * torch.mean(
                aesthetic_apply(aest_params, out_enc))
        for embs, wts, coeff in prompts:
            group = torch.zeros((), device=dev)
            for j in range(embs.shape[0]):
                group = group + wts[j] * sim_func(embs[j:j + 1], out_enc,
                                                  settings.sim)
            loss = loss + coeff * group
        if settings.sync > 0 and lpips_bundle is not None:
            lpips_params, img_in = lpips_bundle
            si = _step_tensor(step_i, dev)
            total = torch.full((), settings.total_steps, dtype=torch.int32,
                               device=dev)
            prog = (total - si).float() / total.float()
            half = resize_bicubic(spar.gather(rgb_r), img_in.shape[-2:])
            loss = loss + prog * settings.sync * torch.mean(
                lpips_apply(lpips_params, half, img_in, normalize=True))
        if settings.rgb_anchors:
            mean_c, std_c = spar.anchors(rgb_r)
            loss = loss + torch.mean(torch.abs(mean_c - 0.45))
            loss = loss + torch.mean(torch.abs(std_c - 0.17))
        if settings.enforce != 0:
            enc2 = encode_cuts(clip_params, draws.cuts2, rgb)
            loss = loss - settings.enforce * sim_func(out_enc, enc2,
                                                      settings.sim)
        if settings.expand > 0:
            gate = (_step_tensor(step_i, dev) > 0).float()
            loss = loss + gate * settings.expand * sim_func(out_enc, prev_enc,
                                                            settings.sim)
        return loss, out_enc.detach()

    return loss_fn


def build_spatial_train_step(spar, sampler, clip_cfg, settings, optimizer):
    """train_step(gen_params, opt_state, prev_enc, clip_params, aest_params,
    lpips_bundle, prompts, draws, step_i) -> (gen_params, opt_state,
    prev_enc, loss): the dense step's signature on the rank's shard and
    its optimizer state, updated in place.  The gradients of the leaves
    every rank holds whole are summed over the spatial group, then every
    gradient over the data axis (when it has more than one rank)."""
    loss_fn = build_spatial_loss_fn(spar, sampler, clip_cfg, settings)
    mesh = spar.mesh

    def train_step(gen_params, opt_state, prev_enc, clip_params, aest_params,
                   lpips_bundle, prompts, draws, step_i):
        ps = leaves(gen_params)
        for p in ps:
            p.requires_grad_(True)
        loss, out_enc = loss_fn(gen_params, clip_params, aest_params,
                                lpips_bundle, prompts, prev_enc, draws,
                                step_i)
        grads = torch.autograd.grad(loss, ps)
        for p in ps:
            p.requires_grad_(False)
        spar.reduce_grads(grads)
        if mesh.size("data") > 1:
            reduce_grads(grads, mesh)
        with torch.no_grad():
            optimizer.step(gen_params, grads, opt_state)
        return gen_params, opt_state, out_enc, loss.detach()

    return train_step


def build_spatial_render(spar):
    """params -> the whole frame [H,W,3] uint8, on every rank."""
    @torch.no_grad()
    def render(gen_params, contrast: float = 1.0):
        img = torch.clamp(spar.render(gen_params, contrast)[0].permute(
            1, 2, 0), 0.0, 1.0)
        return (img * 255.0 + 0.5).to(torch.uint8)
    return render


def build_spatial_train_loop_frames(spar, sampler, clip_cfg, settings,
                                    optimizer, opt_step: int, n_frames: int,
                                    contrast: float = 1.0,
                                    step_index: str = "frame", dual=None):
    """`step.build_train_loop_frames` on the sharded canvas (JAX
    `build_spatial_train_loop_frames`): the same loop, signature and
    cadence, its state the rank's shard, its frames whole on every
    rank."""
    from aphantasia_torch.step import FrameLoop
    if step_index not in ("frame", "step", "global"):
        raise ValueError(f"step_index must be 'frame' or 'step' ('global'), "
                         f"not {step_index!r}")
    cfgs = (clip_cfg,) if dual is None else (clip_cfg, dual[0])
    steps = [build_spatial_train_step(spar, sampler, cfg, settings, optimizer)
             for cfg in cfgs]
    return FrameLoop(steps, build_spatial_render(spar), opt_step, n_frames,
                     contrast, step_index, tuple(spar.size) + (3,),
                     dm_every=None if dual is None else dual[1])


def build_spatial_frame_step(spar, sampler, clip_cfg, settings, optimizer,
                             opt_steps: int, smooth: bool,
                             contrast: float = 1.0, deptha=None,
                             depth: float = 0.0):
    """`step.build_frame_step` on the sharded canvas (JAX
    `build_spatial_frame_step`): the same frame function and signature,
    with `spatial_frame_warp` as the motion warp, the sharded train step,
    the gathered render and, with depth, `spatial_depth_preview`."""
    from aphantasia_torch.step import FrameStep

    class SpatialFrameStep(FrameStep):
        def motion_warp(self, params, motion, depth_map=None):
            return spatial_frame_warp(self, spar, params, motion, depth_map)

        def preview(self, params):
            return spatial_depth_preview(spar, params)

    gen = "RGB" if isinstance(spar, SpatialRGB) else "FFT"
    return SpatialFrameStep(
        spar, sampler, clip_cfg, settings, optimizer, gen, spar.size,
        opt_steps, smooth, contrast, deptha, depth, spar.colors,
        train_step=build_spatial_train_step(spar, sampler, clip_cfg,
                                            settings, optimizer),
        render=build_spatial_render(spar))


def build_spatial_depth_helpers(spar, deptha):
    """`step.build_depth_helpers` on the sharded canvas: `preview(params)`
    (`spatial_depth_preview`) and the same `infer`, one DA-V2 forward of
    the preview and its mirror, a CUDA graph of its own on the card."""
    from aphantasia_torch.motion.depthwarp import mirror_fused_depth
    from aphantasia_torch.step import DepthHelpers, GraphFn
    return DepthHelpers(lambda p: spatial_depth_preview(spar, p), GraphFn(
        lambda x: mirror_fused_depth(deptha, x)))
