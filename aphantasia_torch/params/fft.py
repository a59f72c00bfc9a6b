"""FFT spectrum parameterizer (counterpart of aphantasia_tpu.params.fft).

The trainable state is a real/imag rfft2 spectrum `[1,3,H,W//2+1,2]`;
decoding scales it by a 1/f^decay frequency curve and inverse-rFFTs it to
an image whose global contrast is normalized by its std.

The inverse transform is `torch.fft.irfft2(norm="ortho")`.  The JAX package
runs it as dense DFT matmuls (and in bf16 on the TPU) because XLA's TPU FFT
is slow at these shapes; on the GPU cuFFT is the natural choice and the
decode runs in float32 throughout.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from aphantasia_torch.params.color import to_valid_rgb, un_rgb


def spectrum_to_image(params: torch.Tensor, size) -> torch.Tensor:
    """Raw [...,h,wf,2] real/imag spectrum -> [...,h,w] image (ortho
    irfft2, no decay scaling).

    The trainable spectrum is not Hermitian, and a 2-D complex-to-real
    transform leaves such input to the implementation (cuFFT and pocketfft
    may differ).  So the transform is written out as the JAX package
    defines it: a complex inverse FFT over H, then, with the imaginary
    parts of the DC and Nyquist columns dropped, a real inverse FFT over
    W."""
    h, w = size
    spec = torch.complex(params[..., 0], params[..., 1])
    z = torch.fft.ifft(spec, n=h, dim=-2, norm="ortho")
    keep = torch.ones(z.shape[-1], device=z.device)
    keep[0] = 0.0
    if w % 2 == 0:
        keep[w // 2] = 0.0
    z = torch.complex(z.real, z.imag * keep)
    return torch.fft.irfft(z, n=w, dim=-1, norm="ortho")


def image_to_spectrum(img: torch.Tensor, size) -> torch.Tensor:
    """Inverse of spectrum_to_image."""
    spec = torch.fft.rfft2(img, s=tuple(size), norm="ortho")
    return torch.stack([spec.real, spec.imag], dim=-1)


def rfft2d_freqs(h: int, w: int) -> np.ndarray:
    """2D rfft spectrum frequency magnitudes."""
    fy = np.fft.fftfreq(h)[:, None]
    w2 = (w + 1) // 2 if w % 2 == 1 else w // 2 + 1
    fx = np.fft.fftfreq(w)[:w2]
    return np.sqrt(fx * fx + fy * fy)


def fft_scale(h: int, w: int, decay_power: float = 1.0) -> np.ndarray:
    """Frequency-decay curve `[1,1,h,w//2+1,1]`:
    sqrt(h*w) / max(freq, 4/max(h,w))^decay."""
    freqs = rfft2d_freqs(h, w)
    scale = 1.0 / np.maximum(freqs, 4.0 / max(h, w)) ** decay_power
    scale *= np.sqrt(h * w)
    return scale.astype(np.float32)[None, None, :, :, None]


def fft_init(generator: torch.Generator, shape, sd: float = 0.01) -> torch.Tensor:
    """Random spectrum `sd * randn([1,3,h,w//2+1,2])` on the generator's
    device."""
    n, c, h, w = shape
    return sd * torch.randn((n, c, h, w // 2 + 1, 2), generator=generator,
                            device=generator.device, dtype=torch.float32)


def fft_decode(params: torch.Tensor, scale: torch.Tensor, size,
               shift: torch.Tensor | None = None,
               contrast: float = 1.0) -> torch.Tensor:
    """scaled = scale * (params [+ shift]); image = irfft2(scaled, ortho);
    image *= contrast / std(image) (Bessel-corrected std)."""
    scaled = scale * params
    if shift is not None:
        scaled = scaled + scale * shift
    image = spectrum_to_image(scaled, size)
    return image * contrast / torch.std(image)


def un_spectrum(spectrum: torch.Tensor, decay_power: float) -> torch.Tensor:
    """Undo the decay scaling; the floor frequency here is 1/max(w,h)
    (4/max in the forward scale), as in the reference."""
    h = spectrum.shape[2]
    w = (spectrum.shape[3] - 1) * 2
    freqs = rfft2d_freqs(h, w)
    scale = 1.0 / np.maximum(freqs, 1.0 / max(w, h)) ** decay_power
    scale *= np.sqrt(w * h)
    return spectrum / torch.as_tensor(
        scale.astype(np.float32)[None, None, :, :, None], device=spectrum.device)


def img2fft(img_in, decay: float = 1.0, colors: float = 1.0) -> torch.Tensor:
    """Image -> spectrum params for resume-from-image: un_rgb -> rfft2 ->
    undo the decay curve -> *500000 (the reference's empirical gain)."""
    image_t = un_rgb(img_in, colors=colors)
    h, w = image_t.shape[2], image_t.shape[3]
    spectrum = image_to_spectrum(image_t, (h, w))
    return un_spectrum(spectrum, decay_power=decay) * 500000.0


def resume_fft(resume=None, shape=None, decay: float | None = None,
               colors: float = 1.6, sd: float = 0.01,
               generator: torch.Generator | None = None):
    """Resolve FFT params from None / .pt path / image path / array.
      None        -> 0.01*randn (generator required)
      .pt path    -> loaded params * sd
      image path  -> img2fft(image); returns the image's size
      array/list  -> as-is
    Returns (params on the CPU or the generator's device, size_or_None)."""
    size = None
    if resume is None:
        if generator is None:
            raise ValueError("random init needs a torch.Generator")
        params = fft_init(generator, shape, sd=0.01)
    elif isinstance(resume, str):
        if not os.path.isfile(resume):
            raise FileNotFoundError(f"Snapshot not found: {resume}")
        ext = os.path.splitext(resume)[1].lower()[1:]
        if ext in ("jpg", "jpeg", "png", "tif", "bmp"):
            from aphantasia_torch.io.media import img_read
            img_in = img_read(resume)
            params = img2fft(img_in, decay, colors)
            size = img_in.shape[:2]
        else:
            from aphantasia_torch.io.checkpoint import load_pt
            params = load_pt(resume)
            if isinstance(params, list):
                params = params[0]
            params = torch.as_tensor(np.asarray(params), dtype=torch.float32) * sd
    else:
        if isinstance(resume, list):
            resume = resume[0]
        params = torch.as_tensor(resume)
    return params, size


@functools.lru_cache(maxsize=8)
def _scale_tensor(h: int, w: int, decay_power: float, device: str):
    return torch.as_tensor(fft_scale(h, w, decay_power), device=device)


@dataclasses.dataclass(frozen=True)
class FFTParameterizer:
    """Static decode config: size + decay curve + color head."""
    size: tuple          # (H, W)
    decay_power: float = 1.0
    colors: float = 1.6

    def init(self, generator: torch.Generator, sd: float = 0.01) -> torch.Tensor:
        h, w = self.size
        return fft_init(generator, (1, 3, h, w), sd=sd)

    def decode(self, params, shift=None, contrast: float = 1.0) -> torch.Tensor:
        scale = _scale_tensor(*self.size, self.decay_power, str(params.device))
        return fft_decode(params, scale, self.size, shift, contrast)

    def image(self, params, shift=None, contrast: float = 1.0) -> torch.Tensor:
        """Decode straight to valid RGB in [0,1]."""
        return to_valid_rgb(self.decode(params, shift, contrast),
                            colors=self.colors)
