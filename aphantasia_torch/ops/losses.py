"""Similarity functions, sharpness losses and the LAION aesthetic head
(counterpart of aphantasia_tpu.ops.losses)."""
from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=32)
def _filters(mode: str, device, dtype) -> torch.Tensor:
    """The scharr [2,3,3,3] or sobel [2,1,3,3] filters on a device, built
    once per device and dtype.  Shared: never written to."""
    if mode == "scharr":
        k = np.repeat(_SCHARR[:, None], 3, axis=1)
    else:
        k = _SOBEL[:, None]
    return torch.as_tensor(k, device=device, dtype=dtype)


def derivat(img, mode: str = "sobel"):
    """Sharpness measure of an NCHW image: 'naiv' finite differences,
    'scharr' conv, 'sobel' (kornia spatial_gradient equivalent)."""
    if mode == "scharr":
        k = _filters(mode, img.device, img.dtype)
        return 0.2 * F.conv2d(img, k).abs().mean()
    if mode == "sobel":
        b, c, h, w = img.shape
        x = F.pad(img.reshape(b * c, 1, h, w), (1, 1, 1, 1), mode="reflect")
        return F.conv2d(x, _filters(mode, img.device, img.dtype)).abs().mean()
    dx = (img[:, :, :, 1:] - img[:, :, :, :-1]).abs().mean()
    dy = (img[:, :, 1:, :] - img[:, :, :-1, :]).abs().mean()
    return 0.5 * (dx + dy)


# ------------------------------------------------------------------ aesthetic

def aesthetic_dims(clip_model: str) -> int | None:
    """Embedding width of the LAION aesthetic linear head (None: no head
    for that model)."""
    return (768 if clip_model == "ViT-L/14"
            else 512 if clip_model in ("ViT-B/16", "ViT-B/32") else None)


def aesthetic_init(generator: torch.Generator, clip_model: str = "ViT-B/32"):
    """A random head on the generator's device: w = 0.01 * randn [nf, 1],
    b = 0.  Real weights load through `aesthetic_load`."""
    nf = aesthetic_dims(clip_model)
    if nf is None:
        return None
    dev = generator.device
    return {"w": 0.01 * torch.randn((nf, 1), generator=generator, device=dev),
            "b": torch.zeros((1,), device=dev)}


def aesthetic_get(generator: torch.Generator, clip_model: str = "ViT-B/32",
                  path: str | None = None):
    """The head, on the generator's device, from the explicit path, else
    APHANTASIA_AEST_PT, else a random init with a loud warning."""
    from aphantasia_torch.weights import env_weights, warn_random
    if aesthetic_dims(clip_model) is None:
        return None
    path = env_weights("aesthetic", path)
    if path:
        return aesthetic_load(path, generator.device)
    warn_random(f"aesthetic head ({clip_model})")
    return aesthetic_init(generator, clip_model)


def aesthetic_load(path: str, device="cpu"):
    """A torch `Linear(nf, 1)` state dict checkpoint -> {"w" [nf,1], "b"
    [1]}, float32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {"w": sd["weight"].float().t().contiguous().to(device),
            "b": sd["bias"].float().to(device)}


def aesthetic_apply(params, embeddings):
    """The head's score of each embedding: [S, D] -> [S, 1]."""
    return embeddings @ params["w"] + params["b"]
