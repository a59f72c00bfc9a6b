"""Raw RGB pixel parameterizer (counterpart of aphantasia_tpu.params.pixel).

The trainable state is the raw [1,3,H,W] tensor; the decode rescales its
contrast by the global std (Bessel-corrected), or by the fixed divisor 3.3
when resuming from an image (`fixcontrast`), then the shared color head
maps it to RGB.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from aphantasia_torch.params.color import to_valid_rgb, un_rgb


def pixel_init(generator: torch.Generator, shape, sd: float = 1.0) -> torch.Tensor:
    """sd * randn(shape), float32, on the generator's device."""
    return sd * torch.randn(tuple(shape), generator=generator,
                            device=generator.device, dtype=torch.float32)


def pixel_decode(params: torch.Tensor, shift=None, contrast: float = 1.0,
                 fixcontrast: bool = False) -> torch.Tensor:
    """params * contrast / std(params) (ddof 1), or / 3.3 under
    `fixcontrast`; `shift` is accepted as the FFT decode's is, and
    ignored."""
    del shift
    if fixcontrast:
        return params * contrast / 3.3
    return params * contrast / torch.std(params)


def resume_pixel(resume=None, shape=None, sd: float = 1.0,
                 generator: torch.Generator | None = None):
    """None -> sd * randn (generator required); an image path ->
    3.3 * un_rgb(image, colors=2.0) and the image's size; an array or a
    list of one -> as is.  Returns (params, size_or_None)."""
    size = None
    if resume is None:
        if generator is None:
            raise ValueError("random init needs a torch.Generator")
        params = pixel_init(generator, shape, sd)
    elif isinstance(resume, str):
        if not os.path.isfile(resume):
            raise FileNotFoundError(f"Image not found: {resume}")
        from aphantasia_torch.io.media import img_read
        img_in = img_read(resume)
        params = 3.3 * un_rgb(img_in, colors=2.0)
        size = img_in.shape[:2]
    else:
        if isinstance(resume, list):
            resume = resume[0]
        params = torch.as_tensor(resume)
    return params, size


@dataclasses.dataclass(frozen=True)
class PixelParameterizer:
    """Static decode config: size, color head and `fixcontrast`."""
    size: tuple          # (H, W)
    colors: float = 1.8
    fixcontrast: bool = False

    def init(self, generator: torch.Generator, sd: float = 1.0) -> torch.Tensor:
        h, w = self.size
        return pixel_init(generator, (1, 3, h, w), sd)

    def decode(self, params, shift=None, contrast: float = 1.0) -> torch.Tensor:
        return pixel_decode(params, shift, contrast, self.fixcontrast)

    def image(self, params, shift=None, contrast: float = 1.0) -> torch.Tensor:
        """Decode straight to valid RGB in [0,1]."""
        return to_valid_rgb(self.decode(params, shift, contrast),
                            colors=self.colors)
