"""DWT wavelet-pyramid parameterizer (counterpart of
aphantasia_tpu.params.dwt).

The trainable state is a list [Yl, Yh_1, ..., Yh_J] in pytorch_wavelets'
layout: Yl [N,C,h,w] and Yh_j [N,C,3,h_j,w_j], finest level first,
subbands LH, HL, HH.  Decoding rescales each level by
((h0*w0)/(h*w))**(1-sharp), runs the inverse 2-D DWT and normalises the
image by its std (Bessel-corrected), in float32.

The transform is separable, with half-sample symmetric extension and
pywt's output lengths ((n + L - 1) // 2 a level).  An analysis step is a
stride-2 `F.conv1d` of the extended rows with [rec_lo, rec_hi] (the JAX
package's `lax.conv_general_dilated`); a synthesis step is the stride-2
`F.conv_transpose1d` with the same filters, which computes the full
convolution of the 2x-dilated coefficients that the JAX package writes as
an lhs-dilated correlation with the reversed filters.  The filters and the
extension indices are built once per device (a host table built at every
decode would be a pageable copy, which a CUDA graph's capture refuses).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from aphantasia_torch.params.color import to_valid_rgb, un_rgb
from aphantasia_torch.params.wavelets import dwt_max_level, wavelet_filters


def _sym_indices(n: int, p: int) -> np.ndarray:
    """Half-sample symmetric extension indices: pad p on both sides."""
    left = np.arange(p - 1, -1, -1)
    mid = np.arange(n)
    right = np.arange(n - 1, n - 1 - p, -1)
    return np.concatenate([left, mid, right]).clip(0, n - 1)


@functools.lru_cache(maxsize=64)
def _sym_index_tensor(n: int, p: int, device) -> torch.Tensor:
    """`_sym_indices(n, p)[1:]` (the extension the analysis correlates,
    from its second entry) on a device, once per device.  Shared: never
    written to."""
    return torch.as_tensor(_sym_indices(n, p)[1:], device=device)


@functools.lru_cache(maxsize=32)
def _bank(wave: str, device, dtype) -> torch.Tensor:
    """[rec_lo, rec_hi] as a [2,1,L] tensor on a device, once per device
    and dtype.  Shared: never written to."""
    _, _, rec_lo, rec_hi = wavelet_filters(wave)
    return torch.as_tensor(np.stack([rec_lo, rec_hi])[:, None],
                           device=device, dtype=dtype)


def _dwt_axis(x: torch.Tensor, wave: str, axis: int):
    """One analysis step along `axis`: (lo, hi), each of length
    (n + L - 1) // 2."""
    ker = _bank(wave, x.device, x.dtype)
    length = ker.shape[-1]
    x = torch.movedim(x, axis, -1)
    lead, n = x.shape[:-1], x.shape[-1]
    out_len = (n + length - 1) // 2
    ext = x[..., _sym_index_tensor(n, length - 1, x.device)]
    out = F.conv1d(ext.reshape(-1, 1, ext.shape[-1]), ker, stride=2)
    out = out[..., :out_len].reshape(*lead, 2, out_len)
    return (torch.movedim(out[..., 0, :], -1, axis),
            torch.movedim(out[..., 1, :], -1, axis))


def _idwt_axis(lo: torch.Tensor, hi: torch.Tensor, wave: str, axis: int,
               n_out: int) -> torch.Tensor:
    """One synthesis step along `axis`, cropped to n_out: entry t is entry
    t + L - 2 of the full convolution of the dilated (lo, hi) with
    (rec_lo, rec_hi)."""
    ker = _bank(wave, lo.device, lo.dtype)
    length = ker.shape[-1]
    lo = torch.movedim(lo, axis, -1)
    hi = torch.movedim(hi, axis, -1)
    lead, m = lo.shape[:-1], lo.shape[-1]
    inp = torch.stack([lo, hi], dim=-2).reshape(-1, 2, m)
    out = F.conv_transpose1d(inp, ker, stride=2)
    out = out[:, 0, length - 2:length - 2 + n_out].reshape(*lead, n_out)
    return torch.movedim(out, -1, axis)


def wavedec2(x: torch.Tensor, wave: str, level: int):
    """[N,C,H,W] -> (Yl, [Yh_1..Yh_J]): pytorch_wavelets' DWTForward layout
    (finest detail first; subbands stacked as LH, HL, HH)."""
    yh = []
    ll = x
    for _ in range(level):
        lo_w, hi_w = _dwt_axis(ll, wave, axis=-1)
        ll_, lh = _dwt_axis(lo_w, wave, axis=-2)
        hl, hh = _dwt_axis(hi_w, wave, axis=-2)
        yh.append(torch.stack([lh, hl, hh], dim=2))
        ll = ll_
    return ll, yh


def waverec2(yl: torch.Tensor, yhs, wave: str, out_size) -> torch.Tensor:
    """Inverse of wavedec2; `out_size` = (H, W) of the original frame."""
    ll = yl
    for j in range(len(yhs) - 1, -1, -1):
        yh = yhs[j]
        lh, hl, hh = yh[:, :, 0], yh[:, :, 1], yh[:, :, 2]
        th, tw = yhs[j - 1].shape[-2:] if j > 0 else out_size
        # crop ll to the detail's size (odd-length bookkeeping)
        ll = ll[..., :lh.shape[-2], :lh.shape[-1]]
        lo_w = _idwt_axis(ll, lh, wave, axis=-2, n_out=th)
        hi_w = _idwt_axis(hl, hh, wave, axis=-2, n_out=th)
        ll = _idwt_axis(lo_w, hi_w, wave, axis=-1, n_out=tw)
    return ll


def dwt_shapes(size, wave: str, level: int):
    """Subband shapes for [1,3,H,W]: [Yl_shape, Yh1_shape, ...]."""
    length = len(wavelet_filters(wave)[2])
    h, w = size
    hs = []
    for _ in range(level):
        h2, w2 = (h + length - 1) // 2, (w + length - 1) // 2
        hs.append((1, 3, 3, h2, w2))
        h, w = h2, w2
    return [(1, 3, h, w)] + hs


def dwt_scale(params, sharp: float):
    """Per-level sharpness rescale factors (host floats from the shapes)."""
    h0, w0 = params[1].shape[3:5]
    scale = []
    for i in range(len(params) - 1):
        h, w = params[i + 1].shape[3:5]
        scale.append(((h0 * w0) / (h * w)) ** (1.0 - sharp))
    return scale


def img2dwt(img_in, wave: str = "coif2", sharp: float = 0.3,
            colors: float = 1.0):
    """Image -> DWT params for resume-from-image."""
    image_t = un_rgb(img_in, colors=colors)
    h, w = image_t.shape[2:]
    yl, yhs = wavedec2(image_t, wave, dwt_max_level(min(h, w)))
    ys = [yl, *yhs]
    scale = dwt_scale(ys, sharp)
    return [ys[0]] + [ys[i + 1] / scale[i] for i in range(len(ys) - 1)]


@dataclasses.dataclass(frozen=True)
class DWTParameterizer:
    """Wavelet-pyramid generator: static decode config."""
    size: tuple          # (H, W)
    wave: str = "coif2"
    sharp: float = 0.3
    colors: float = 1.6

    @property
    def level(self) -> int:
        # the reference computes maxlevel with db1 whatever the wavelet
        return dwt_max_level(min(self.size))

    @property
    def shapes(self):
        return dwt_shapes(self.size, self.wave, self.level)

    def init(self, generator: torch.Generator, sd: float = 1.0):
        """`sd * randn` for every subband, on the generator's device."""
        return [sd * torch.randn(s, generator=generator,
                                 device=generator.device, dtype=torch.float32)
                for s in self.shapes]

    def decode(self, params, shift=None, contrast: float = 1.0):
        del shift  # the DWT decode takes no spectrum shift
        scale = dwt_scale(params, self.sharp)
        yhs = [params[i + 1] * scale[i] for i in range(len(params) - 1)]
        image = waverec2(params[0], yhs, self.wave, self.size)
        return image * contrast / torch.std(image)

    def image(self, params, shift=None, contrast: float = 1.0):
        """Decode straight to valid RGB in [0,1]."""
        return to_valid_rgb(self.decode(params, shift, contrast),
                            colors=self.colors)


def resume_dwt(resume, size, wave: str, colors: float,
               generator: torch.Generator | None = None, sharp: float = 0.3):
    """None / .pt path / image path / list -> (params list, size or None).
      None        -> DWTParameterizer.init (generator required)
      .pt path    -> the saved list
      image path  -> img2dwt(image); returns the image's size
      list        -> as is"""
    if resume is None:
        if generator is None:
            raise ValueError("random init needs a torch.Generator")
        return DWTParameterizer(tuple(size), wave, sharp, colors).init(
            generator), None
    if isinstance(resume, str):
        if not os.path.isfile(resume):
            raise FileNotFoundError(f"Snapshot not found: {resume}")
        ext = os.path.splitext(resume)[1].lower()[1:]
        if ext in ("jpg", "jpeg", "png", "tif", "bmp"):
            from aphantasia_torch.io.media import img_read
            img_in = img_read(resume)
            return (img2dwt(img_in, wave=wave, sharp=sharp, colors=colors),
                    img_in.shape[:2])
        from aphantasia_torch.io.checkpoint import load_pt
        return [torch.as_tensor(np.asarray(y), dtype=torch.float32)
                for y in load_pt(resume)], None
    return [torch.as_tensor(y) for y in resume], None
