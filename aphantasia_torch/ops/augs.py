"""Batched augmentation pipelines for cutouts (counterpart of
aphantasia_tpu.ops.augs).

Every pipeline is split into a *draw* (`draw(generator, s, h, w)`, the
random parameters of all S cutouts as tensors) and an *apply*
(`apply(draws, cuts)`), so a test can hand both frameworks the same draws.

`fast` (the default) is the reference's RandomPerspective(0.33, p=0.2) +
RandomErasing(0.2) + rotate(+-30 deg, 20x zero-weighted) + CLIP normalize,
with the perspective entering as its least-squares affine fit, composed
with the rotation into ONE separable warp (ops/sep_warp.py), erasing after.
`none` only normalizes.  The other pipelines are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from aphantasia_torch.ops.perspective import (affine_fit_centered,
                                              perspective_coeffs,
                                              perspective_endpoints)
from aphantasia_torch.ops.sep_warp import affine_warp
from aphantasia_torch.params.color import clip_normalize

# rotate angle choices: list(range(-30, 30)) + 20*[0]
_ROT_ANGLES = np.asarray(list(range(-30, 30)) + [0] * 20, dtype=np.float32)


def _rot_a2(angles_deg):
    """[S] -> [S,2,2] inverse rotation (centered coords)."""
    r = torch.deg2rad(angles_deg)
    cos, sin = torch.cos(r), torch.sin(r)
    return torch.stack([torch.stack([cos, sin], -1),
                        torch.stack([-sin, cos], -1)], -2)


def _compose(a, b):
    """Affine composition: out(x) = in(A(B(x))) as one [S,2,3] map."""
    a2, at = a[:, :, :2], a[:, :, 2]
    b2, bt = b[:, :, :2], b[:, :, 2]
    c2 = torch.bmm(a2, b2)
    ct = torch.einsum("sij,sj->si", a2, bt) + at
    return torch.cat([c2, ct[:, :, None]], -1)


def random_rotate_affine(rot_idx, angles=_ROT_ANGLES):
    """Drawn angle indices [S] -> rotation affines [S,2,3]."""
    ang = torch.as_tensor(angles, device=rot_idx.device)[rot_idx.long()]
    a2 = _rot_a2(ang)
    return torch.cat([a2, torch.zeros_like(a2[:, :, :1])], -1)


class ErasingDraws(NamedTuple):
    """torchvision RandomErasing draws, one per cutout: `apply` (bool),
    `area` (fraction of the cutout, in `scale`), `logr` (log aspect, in
    log(`ratio`)), `y0u`/`x0u` (unit uniforms placing the rectangle)."""
    apply: torch.Tensor
    area: torch.Tensor
    logr: torch.Tensor
    y0u: torch.Tensor
    x0u: torch.Tensor


def draw_erasing(generator: torch.Generator, s: int, p: float = 0.2,
                 scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> ErasingDraws:
    kw = dict(generator=generator, device=generator.device)

    def uni(lo, hi):
        return torch.rand(s, **kw) * (hi - lo) + lo

    return ErasingDraws(torch.rand(s, **kw) < p, uni(*scale),
                        uni(math.log(ratio[0]), math.log(ratio[1])),
                        torch.rand(s, **kw), torch.rand(s, **kw))


def random_erasing(draws: ErasingDraws, cuts, value: float = 0.0):
    """Set each drawn rectangle to `value` where `apply` is set."""
    s, c, h, w = cuts.shape
    area = draws.area * h * w
    r = torch.exp(draws.logr)
    eh = torch.clamp(torch.sqrt(area * r), 1, h - 1)
    ew = torch.clamp(torch.sqrt(area / r), 1, w - 1)
    y0 = draws.y0u * (h - eh)
    x0 = draws.x0u * (w - ew)
    yy = torch.arange(h, dtype=torch.float32, device=cuts.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=cuts.device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + eh)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + ew)[:, None, None]))
    mask = inside & draws.apply[:, None, None]
    return torch.where(mask[:, None], torch.full_like(cuts, value), cuts)


class FastDraws(NamedTuple):
    """Draws of the `fast` pipeline: perspective corner endpoints
    [S,4,2], rotation angle indices [S], erasing rectangles."""
    endpoints: torch.Tensor
    rot_idx: torch.Tensor
    erasing: ErasingDraws


def draw_fast(generator: torch.Generator, s: int, h: int, w: int) -> FastDraws:
    _, end = perspective_endpoints(generator, s, h, w, distortion=0.33, p=0.2)
    rot = torch.randint(0, len(_ROT_ANGLES), (s,), generator=generator,
                        device=generator.device)
    return FastDraws(end, rot, draw_erasing(generator, s))


def transforms_fast_affine(draws: FastDraws, cuts,
                           compute_dtype=torch.bfloat16):
    """The default `fast` pipeline: perspective as its affine fit, composed
    with the rotation into one warp (bf16 matmuls, as in the JAX package),
    erasing after, then CLIP normalize."""
    s, c, h, w = cuts.shape
    start = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                         dtype=torch.float32, device=cuts.device)
    aff_p = affine_fit_centered(perspective_coeffs(start, draws.endpoints),
                                h, w)
    aff = _compose(aff_p, random_rotate_affine(draws.rot_idx))
    cuts = affine_warp(cuts, aff, pad=56, compute_dtype=compute_dtype)
    cuts = random_erasing(draws.erasing, cuts)
    return clip_normalize(cuts)


def normalize_only(draws, cuts):
    del draws
    return clip_normalize(cuts)


@dataclasses.dataclass(frozen=True)
class Transform:
    """A pipeline as its draw and its apply."""
    draw: Callable
    apply: Callable


_NOT_PORTED = ("custom", "elastic", "lucent", "openai")


def get_transform(name: str) -> Transform:
    """'fast' | 'none' -> Transform.  The other names of the JAX package
    raise NotImplementedError until they are ported (ROADMAP.md)."""
    if name == "fast":
        return Transform(draw_fast, transforms_fast_affine)
    if name == "none":
        return Transform(lambda generator, s, h, w: None, normalize_only)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"transform {name!r} is not ported to aphantasia_torch yet; "
            "see ROADMAP.md (use 'fast' or 'none')")
    raise ValueError(f"unknown transform {name!r}")
