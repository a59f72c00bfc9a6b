"""Shared color head: Lucent-style color decorrelation + sigmoid
(counterpart of aphantasia_tpu.params.color)."""
from __future__ import annotations

import functools

import numpy as np
import torch

# sqrt of the ImageNet color correlation (Lucid)
_COLOR_CORRELATION_SVD_SQRT = np.asarray(
    [[0.26, 0.09, 0.02],
     [0.27, 0.00, -0.05],
     [0.27, -0.09, 0.03]], dtype=np.float64)

# CLIP input normalization
CLIP_MEAN = np.asarray((0.48145466, 0.4578275, 0.40821073), dtype=np.float32)
CLIP_STD = np.asarray((0.26862954, 0.26130258, 0.27577711), dtype=np.float32)


def color_matrix(colors: float = 1.0) -> np.ndarray:
    """Normalized decorrelation matrix, transposed for `image @ M`:
    first row divided by `colors` (saturation), normalized by the max
    column norm.  float32 numpy [3,3]."""
    m = _COLOR_CORRELATION_SVD_SQRT / np.asarray([colors, 1.0, 1.0])[:, None]
    max_norm = np.linalg.norm(m, axis=0).max()
    return (m / max_norm).T.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _color_tensor(colors: float, device, dtype) -> torch.Tensor:
    """color_matrix(colors) on a device, built once per device and dtype
    (a per-call host table is a pageable copy that a CUDA graph refuses).
    Shared: never written to."""
    return torch.as_tensor(color_matrix(colors), device=device, dtype=dtype)


@functools.lru_cache(maxsize=32)
def _clip_mean_std(device, dtype):
    """CLIP_MEAN and CLIP_STD as [1,3,1,1] tensors, once per device and
    dtype."""
    return tuple(torch.as_tensor(v, device=device, dtype=dtype)[None, :, None,
                                                               None]
                 for v in (CLIP_MEAN, CLIP_STD))


def decorrelate(image: torch.Tensor, colcorr_t: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nchw,cd->ndhw", image, colcorr_t)


def to_valid_rgb(image: torch.Tensor, colors: float = 1.0,
                 decorrelate_colors: bool = True) -> torch.Tensor:
    """Decoded parameterizer output -> valid RGB in [0,1]."""
    if decorrelate_colors:
        image = decorrelate(image, _color_tensor(colors, image.device,
                                                 image.dtype))
    return torch.sigmoid(image)


def clip_normalize(image: torch.Tensor) -> torch.Tensor:
    """CLIP mean/std normalization over an NCHW batch, in the image's
    dtype (a bf16 pipeline stays bf16 into the tower)."""
    mean, std = _clip_mean_std(image.device, image.dtype)
    return (image - mean) / std


def un_rgb(image, colors: float = 1.0) -> torch.Tensor:
    """Inverse color transform used when resuming from an image: CLIP-
    normalize the [0,1] image, then apply the inverse decorrelation.
    Accepts [1,3,H,W] float in [0,1] or an HWC 0..255 array."""
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image), dtype=torch.float32)
    if image.ndim == 3:  # HWC [0..255]
        image = image.permute(2, 0, 1)[None] / 255.0
    inv = np.linalg.inv(color_matrix(colors)).astype(np.float32)
    image = clip_normalize(image)
    return torch.einsum("nchw,cd->ndhw", image,
                        torch.as_tensor(inv, device=image.device))


def inv_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Numerically clamped logit."""
    eps = 1e-12
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x)).float()
