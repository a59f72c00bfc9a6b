"""Similarity functions and sharpness losses (counterpart of
aphantasia_tpu.ops.losses).  The LAION aesthetic head is not ported yet."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def cossim(v1, v2, eps=1e-8):
    """torch.cosine_similarity(dim=-1) semantics, each norm clamped."""
    n1 = torch.clamp(torch.linalg.norm(v1, dim=-1), min=eps)
    n2 = torch.clamp(torch.linalg.norm(v2, dim=-1), min=eps)
    return (v1 * v2).sum(-1) / (n1 * n2)


def dot_compare(v1, v2, cossim_pow=0):
    dot = (v1 * v2).sum()
    mag = torch.sqrt((v2 ** 2).sum())
    cs = dot / (1e-6 + mag)
    return dot * cs ** cossim_pow


def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _spherical(v1, v2):
    d = torch.linalg.norm(_normalize(v1) - _normalize(v2), dim=-1)
    return 2.0 * torch.arcsin(d / 2.0) ** 2


def sim_func(v1, v2, type: str | None = None):
    """cossim (default) / dot / angular / spherical / mix
    (= cossim - 0.25 * spherical)."""
    if type is not None and "mix" in type:
        return cossim(v1, v2).mean() - 0.25 * torch.abs(_spherical(v1, v2)).mean()
    if type is not None and "spher" in type:
        return _spherical(v1, v2)
    if type is not None and "ang" in type:
        cs = torch.clamp(cossim(v1, v2), -1.0, 1.0)
        return 1.0 - torch.arccos(cs).mean() / math.pi
    if type is not None and "dot" in type:
        return dot_compare(v1, v2, cossim_pow=1)
    return cossim(v1, v2).mean()


_SCHARR = np.asarray(
    [[[-0.183, 0.0, 0.183], [-0.634, 0.0, 0.634], [-0.183, 0.0, 0.183]],
     [[-0.183, -0.634, -0.183], [0.0, 0.0, 0.0], [0.183, 0.634, 0.183]]],
    dtype=np.float32)

# Sobel kernels, kornia-normalized (divided by weight sum 8)
_SOBEL = np.asarray(
    [[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
     [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]], dtype=np.float32) / 8.0


def derivat(img, mode: str = "sobel"):
    """Sharpness measure of an NCHW image: 'naiv' finite differences,
    'scharr' conv, 'sobel' (kornia spatial_gradient equivalent)."""
    if mode == "scharr":
        k = torch.as_tensor(np.repeat(_SCHARR[:, None], 3, axis=1),
                            device=img.device, dtype=img.dtype)  # [2,3,3,3]
        return 0.2 * F.conv2d(img, k).abs().mean()
    if mode == "sobel":
        b, c, h, w = img.shape
        x = F.pad(img.reshape(b * c, 1, h, w), (1, 1, 1, 1), mode="reflect")
        k = torch.as_tensor(_SOBEL[:, None], device=img.device,
                            dtype=img.dtype)                     # [2,1,3,3]
        return F.conv2d(x, k).abs().mean()
    dx = (img[:, :, :, 1:] - img[:, :, :, :-1]).abs().mean()
    dy = (img[:, :, 1:, :] - img[:, :, :-1, :]).abs().mean()
    return 0.5 * (dx + dy)
