"""Batched augmentation pipelines for cutouts (counterpart of
aphantasia_tpu.ops.augs).

Every pipeline is split into a *draw* (`draw(generator, s, h, w)`, the
random parameters of all S cutouts as tensors) and an *apply*
(`apply(draws, cuts)`), so a test can hand both frameworks the same draws.

`fast` (the default) is the reference's RandomPerspective(0.33, p=0.2) +
RandomErasing(0.2) + rotate(+-30 deg, 20x zero-weighted) + CLIP normalize.
Its perspective comes in three modes, which share one draw (`FastDraws`):
`affine` enters it as its least-squares affine fit, composed with the
rotation into ONE separable warp (ops/sep_warp.py), erasing after;
`mixed` applies the exact homography through the CUDA kernel of
ops/persp.py, then erasing, then the rotation as the affine warp; `exact`
also rotates through that kernel (a rotation is a homography).
`custom`, `elastic`, `lucent` and `openai` compose their affine stages
into one affine warp with gray fill; `elastic` then adds smooth separable
displacements by fractional shifts.  `none` only normalizes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import torch

from aphantasia_torch.ops.persp import perspective_warp
from aphantasia_torch.ops.perspective import (affine_fit_centered,
                                              perspective_coeffs,
                                              perspective_endpoints,
                                              rotation_coeffs_for,
                                              start_points)
from aphantasia_torch.ops.resize import resize_cubic_last
from aphantasia_torch.ops.sep_warp import affine_warp, fractional_shift
from aphantasia_torch.params.color import clip_normalize

# rotate angle choices: list(range(-30, 30)) + 20*[0]
_ROT_ANGLES = tuple(float(a) for a in list(range(-30, 30)) + [0] * 20)


@functools.lru_cache(maxsize=32)
def _table(values: tuple, device) -> torch.Tensor:
    """A float32 choice table (angles, scales) on a device, built once per
    device: a per-call host table is a pageable copy, which makes the
    host wait for the card and which a CUDA graph refuses.  Shared: never
    written to."""
    return torch.tensor(values, dtype=torch.float32, device=device)


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


def _angles(rot_idx, angles=_ROT_ANGLES):
    return _table(angles, rot_idx.device)[rot_idx.long()]


def random_rotate_affine(rot_idx, angles=_ROT_ANGLES):
    """Drawn angle indices [S] -> rotation affines [S,2,3]."""
    a2 = _rot_a2(_angles(rot_idx, angles))
    return torch.cat([a2, torch.zeros_like(a2[:, :, :1])], -1)


def _jitter_affine(dxy):
    """jitter(d): drawn integer translates dxy [S,2] in {0..d-1} -> affines
    [S,2,3] with the inverse map src = dst - dxy."""
    eye = torch.eye(2, device=dxy.device).expand(dxy.shape[0], 2, 2)
    return torch.cat([eye, -dxy.float()[:, :, None]], -1)


def _pad_affine(s, h, pad_px, device):
    """Constant-border pad(p) at fixed shape: a centred scale-down by
    h/(h+2p) (the inverse map scales up), border filled by the warp."""
    pad_scale = (h + 2.0 * pad_px) / h
    a = torch.cat([pad_scale * torch.eye(2, device=device),
                   torch.zeros((2, 1), device=device)], 1)
    return a.expand(s, 2, 3)


def _scale_affine(scale_idx, scales):
    """lucent random_scale: per-sample centred content scale, src =
    dst / scale."""
    sc = _table(scales, scale_idx.device)[scale_idx.long()]
    a2 = torch.eye(2, device=sc.device)[None] / sc[:, None, None]
    return torch.cat([a2, torch.zeros_like(a2[:, :, :1])], -1)


def _randint(generator, hi, shape):
    return torch.randint(0, hi, shape, generator=generator,
                         device=generator.device)


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
    """Draws of the `fast` pipeline in all three perspective modes:
    perspective corner endpoints [S,4,2], rotation angle indices [S],
    erasing rectangles."""
    endpoints: torch.Tensor
    rot_idx: torch.Tensor
    erasing: ErasingDraws


def draw_fast(generator: torch.Generator, s: int, h: int, w: int) -> FastDraws:
    _, end = perspective_endpoints(generator, s, h, w, distortion=0.33, p=0.2)
    rot = _randint(generator, len(_ROT_ANGLES), (s,))
    return FastDraws(end, rot, draw_erasing(generator, s))


def transforms_fast_affine(draws: FastDraws, cuts,
                           compute_dtype=torch.bfloat16):
    """The default `fast` pipeline: perspective as its affine fit, composed
    with the rotation into one warp (bf16 matmuls, as in the JAX package),
    erasing after, then CLIP normalize."""
    s, c, h, w = cuts.shape
    aff_p = affine_fit_centered(
        perspective_coeffs(start_points(h, w, cuts.device), draws.endpoints),
        h, w)
    aff = _compose(aff_p, random_rotate_affine(draws.rot_idx))
    cuts = affine_warp(cuts, aff, pad=56, compute_dtype=compute_dtype)
    cuts = random_erasing(draws.erasing, cuts)
    return clip_normalize(cuts)


def _exact_perspective(draws: FastDraws, cuts):
    """The drawn homographies through the perspective kernel; a sample
    whose corners did not move is copied."""
    s, c, h, w = cuts.shape
    start = start_points(h, w, cuts.device)
    coef = perspective_coeffs(start, draws.endpoints)
    flags = (torch.abs(draws.endpoints - start[None]).amax((1, 2)) > 0)
    return perspective_warp(cuts, coef, flags.to(torch.int32))


def transforms_fast_mixed(draws: FastDraws, cuts,
                          compute_dtype=torch.bfloat16):
    """`--persp mixed`: the exact perspective (kernel), erasing, then the
    rotation as one affine warp (bf16 matmuls), then CLIP normalize."""
    cuts = _exact_perspective(draws, cuts)
    cuts = random_erasing(draws.erasing, cuts)
    cuts = affine_warp(cuts, random_rotate_affine(draws.rot_idx), pad=56,
                       compute_dtype=compute_dtype)
    return clip_normalize(cuts)


def transforms_fast(draws: FastDraws, cuts):
    """`--persp exact`: torchvision's stages in its order, each exact: the
    perspective (kernel), erasing, the rotation through the same kernel
    (family "rotate"; an angle of 0 copies), then CLIP normalize."""
    s, c, h, w = cuts.shape
    cuts = _exact_perspective(draws, cuts)
    cuts = random_erasing(draws.erasing, cuts)
    ang = _angles(draws.rot_idx)
    rcoef = rotation_coeffs_for(ang, h, w)
    rflags = (torch.abs(ang) > 0).to(torch.int32)
    cuts = perspective_warp(cuts, rcoef, rflags, family="rotate")
    return clip_normalize(cuts)


class CustomDraws(NamedTuple):
    """`custom`: rotation angle indices [S], jitter(8) translates [S,2]."""
    rot_idx: torch.Tensor
    jitter: torch.Tensor


def draw_custom(generator: torch.Generator, s: int, h: int, w: int):
    return CustomDraws(_randint(generator, len(_ROT_ANGLES), (s,)),
                       _randint(generator, 8, (s, 2)))


def transforms_custom(draws: CustomDraws, cuts, compute_dtype=torch.bfloat16):
    """pad(4, gray) + rotate + jitter(8) + normalize, as one affine warp
    with 0.5 fill."""
    s, c, h, w = cuts.shape
    scale = _pad_affine(s, h, 4, cuts.device)
    aff = _compose(scale, _compose(random_rotate_affine(draws.rot_idx),
                                   _jitter_affine(draws.jitter)))
    cuts = affine_warp(cuts, aff, pad=56, fill=0.5,
                       compute_dtype=compute_dtype)
    return clip_normalize(cuts)


class ElasticDraws(NamedTuple):
    """`elastic`: rotation indices [S], jitter(8) translates [S,2], erasing
    rectangles, and the coarse displacement tracks [S,9] in [-1, 1) of the
    per-row x-shift and the per-column y-shift."""
    rot_idx: torch.Tensor
    jitter: torch.Tensor
    erasing: ErasingDraws
    coarse_x: torch.Tensor
    coarse_y: torch.Tensor


def draw_elastic(generator: torch.Generator, s: int, h: int, w: int):
    rot = _randint(generator, len(_ROT_ANGLES), (s,))
    jit = _randint(generator, 8, (s, 2))
    er = draw_erasing(generator, s)

    def coarse():
        return torch.rand((s, 9), generator=generator,
                          device=generator.device) * 2.0 - 1.0
    return ElasticDraws(rot, jit, er, coarse(), coarse())


def transforms_elastic(draws: ElasticDraws, cuts,
                       compute_dtype=torch.bfloat16):
    """rotate + jitter(8) as one affine warp with gray fill, erasing, then
    a smooth separable displacement (amplitude 6 px): the coarse tracks
    upsampled by the cubic resize of `jax.image.resize` shift each row
    along x and each column along y by fractional shifts, then normalize."""
    s, c, h, w = cuts.shape
    aff = _compose(random_rotate_affine(draws.rot_idx),
                   _jitter_affine(draws.jitter))
    cuts = affine_warp(cuts, aff, pad=56, fill=0.5,
                       compute_dtype=compute_dtype)
    cuts = random_erasing(draws.erasing, cuts)
    dx = resize_cubic_last(draws.coarse_x, h) * 6.0      # x-shift per row
    dy = resize_cubic_last(draws.coarse_y, w) * 6.0      # y-shift per column
    cuts = fractional_shift(cuts, dx[:, None, :], axis=-1)
    cuts = fractional_shift(cuts, dy[:, None, :], axis=-2)
    return clip_normalize(cuts)


_LUCENT_SCALES = tuple(1 + (i - 5) / 50.0 for i in range(11))
_LUCENT_ANGLES = tuple(float(a) for a in list(range(-10, 11)) + [0] * 5)


class LucentDraws(NamedTuple):
    """`lucent`: jitter(8) [S,2], scale indices [S], rotation indices [S]
    (of +-10 deg, 5x zero-weighted), jitter(4) [S,2]."""
    jitter8: torch.Tensor
    scale_idx: torch.Tensor
    rot_idx: torch.Tensor
    jitter4: torch.Tensor


def draw_lucent(generator: torch.Generator, s: int, h: int, w: int):
    return LucentDraws(_randint(generator, 8, (s, 2)),
                       _randint(generator, len(_LUCENT_SCALES), (s,)),
                       _randint(generator, len(_LUCENT_ANGLES), (s,)),
                       _randint(generator, 4, (s, 2)))


def transforms_lucent(draws: LucentDraws, cuts, compute_dtype=torch.bfloat16):
    """Legacy Lucid pipeline: pad(12, gray) + jitter(8) + random_scale(0.9
    ..1.1 step .02) + rotate(+-10 deg, 5x0) + jitter(4), composed into one
    affine warp with gray fill, then CLIP normalize."""
    s, c, h, w = cuts.shape
    aff = _compose(_pad_affine(s, h, 12, cuts.device),
                   _compose(_jitter_affine(draws.jitter8),
                            _compose(_scale_affine(draws.scale_idx,
                                                   _LUCENT_SCALES),
                                     _compose(random_rotate_affine(
                                         draws.rot_idx, _LUCENT_ANGLES),
                                         _jitter_affine(draws.jitter4)))))
    cuts = affine_warp(cuts, aff, pad=56, fill=0.5,
                       compute_dtype=compute_dtype)
    return clip_normalize(cuts)


_OPENAI_ANGLES = tuple(float(a) for a in list(range(-20, 20))
                       + list(range(-10, 10)) + list(range(-5, 5)) + [0] * 5)


class OpenAIDraws(NamedTuple):
    """`openai`: the sum [S,2] of ten jitter(4) translates, rotation
    indices [S] (of -20..20, -10..10, -5..5 and 5x0), jitter(2) [S,2]."""
    jitter10: torch.Tensor
    rot_idx: torch.Tensor
    jitter2: torch.Tensor


def draw_openai(generator: torch.Generator, s: int, h: int, w: int):
    jit10 = sum(_randint(generator, 4, (s, 2)) for _ in range(10))
    return OpenAIDraws(jit10, _randint(generator, len(_OPENAI_ANGLES), (s,)),
                       _randint(generator, 2, (s, 2)))


def transforms_openai(draws: OpenAIDraws, cuts, compute_dtype=torch.bfloat16):
    """Legacy OpenAI pipeline: pad(2, gray) + 10x jitter(4) + rotate +
    jitter(2), composed into one affine warp with gray fill (ten composed
    integer jitters are one translation by their sum), then normalize."""
    s, c, h, w = cuts.shape
    aff = _compose(_pad_affine(s, h, 2, cuts.device),
                   _compose(_jitter_affine(draws.jitter10),
                            _compose(random_rotate_affine(draws.rot_idx,
                                                          _OPENAI_ANGLES),
                                     _jitter_affine(draws.jitter2))))
    cuts = affine_warp(cuts, aff, pad=56, fill=0.5,
                       compute_dtype=compute_dtype)
    return clip_normalize(cuts)


def normalize_only(draws, cuts):
    del draws
    return clip_normalize(cuts)


@dataclasses.dataclass(frozen=True)
class Transform:
    """A pipeline as its draw and its apply."""
    draw: Callable
    apply: Callable


PERSP_MODES = ("affine", "mixed", "exact")
_FAST = {"affine": transforms_fast_affine, "mixed": transforms_fast_mixed,
         "exact": transforms_fast}
_OTHERS = {
    "custom": Transform(draw_custom, transforms_custom),
    "elastic": Transform(draw_elastic, transforms_elastic),
    "lucent": Transform(draw_lucent, transforms_lucent),
    "openai": Transform(draw_openai, transforms_openai),
    "none": Transform(lambda generator, s, h, w: None, normalize_only),
}
TRANSFORMS = ("fast",) + tuple(_OTHERS)


def get_transform(name: str, persp: str = "affine") -> Transform:
    """'fast' | 'custom' | 'elastic' | 'lucent' | 'openai' | 'none' ->
    Transform.  `persp` ('affine', 'mixed' or 'exact') selects the `fast`
    pipeline's perspective mode; the three share `draw_fast`."""
    if persp not in PERSP_MODES:
        raise ValueError(f"unknown perspective mode {persp!r}")
    if name == "fast":
        return Transform(draw_fast, _FAST[persp])
    if name in _OTHERS:
        return _OTHERS[name]
    raise ValueError(f"unknown transform {name!r}")
