"""Keyframe animation curves in host numpy and scipy (counterpart of
aphantasia_tpu.motion.anima, whose numbers they reproduce): random key
points every `transit` frames, interpolated by lerp, slerp or a cubic
spline with smoothstep easing, optional gaussian smoothing and looping,
all segments in one broadcast pass.  They run once a run, before the
frames; the seeds go to an explicit `numpy.random.RandomState`, so a seed
gives the JAX package's schedule exactly.
"""
from __future__ import annotations

import math
import time

import numpy as np
import scipy.special
from scipy.interpolate import CubicSpline
from scipy.ndimage import gaussian_filter


def get_z(shape, rnd, uniform: bool = False):
    return rnd.uniform(0.0, 1.0, shape) if uniform else rnd.randn(*shape)


def smoothstep(x, nn=1.0, xmin=0.0, xmax=1.0):
    """Generalized smoothstep of (possibly fractional) order `nn`:
    S_n(x) = x^(n+1) * sum_i C(n+i,i)*C(2n+1,n-i)*(-x)^i; a fractional
    order averages with the identity ramp."""
    n = math.ceil(nn)
    x = np.clip((np.asarray(x, dtype=float) - xmin) / (xmax - xmin), 0, 1)
    i = np.arange(n + 1)
    coef = scipy.special.comb(n + i, i) * scipy.special.comb(2 * n + 1, n - i)
    # sum_i coef[i] * (-x)^i, evaluated as a polynomial in (-x)
    series = np.polynomial.polynomial.polyval(-x, coef)
    result = x ** (n + 1) * series
    if nn != n:
        result = (x + result) / 2
    return result if result.ndim else float(result)


def _ease(num_steps: int, smooth: float) -> np.ndarray:
    """The eased [0,1] sample grid shared by lerp/slerp."""
    xs = np.linspace(0.0, 1.0, num_steps)
    return smoothstep(xs, smooth) if smooth > 0 else xs


def lerp(z1, z2, num_steps, smooth: float = 0.0, batched: bool = False):
    """Linear interpolation -> [num_steps, *z.shape].  With `batched`, axis 0
    of z1/z2 is a segment batch and each segment interpolates independently."""
    z1, z2 = np.asarray(z1, float), np.asarray(z2, float)
    xs = _ease(num_steps, smooth).reshape((-1,) + (1,) * z1.ndim)
    return z1[None] + (z2 - z1)[None] * xs


def _norm(z, batched: bool):
    """Norm over everything except the segment batch axis, kept broadcastable."""
    axes = tuple(range(1 if batched else 0, z.ndim))
    return np.sqrt(np.sum(z * z, axis=axes, keepdims=True))


def slerp_np(z1, z2, num_steps, smooth: float = 0.0, batched: bool = False):
    """Hypersphere interpolation, vectorized: the linear path is
    renormalized to the norm of the equal-norm chord."""
    z1, z2 = np.asarray(z1, float), np.asarray(z2, float)
    xs = _ease(num_steps, smooth).reshape((-1,) + (1,) * z1.ndim)
    n1 = _norm(z1, batched)
    n2 = _norm(z2, batched)
    z2_equal = z2 * (n1 / n2)                                 # same norm as z1
    plain = z1[None] + (z2 - z1)[None] * xs                   # [T, (S,) ...]
    chord = z1[None] + (z2_equal - z1)[None] * xs
    chord_norm = np.stack([_norm(c, batched) for c in chord])
    return plain * (n1[None] / chord_norm)


def cublerp(points, steps, fstep, looped: bool = True):
    """Cubic-spline keypoint interpolation."""
    keys = np.arange(steps + 1) * fstep
    last = 0 if looped else -1
    points = np.concatenate((points, points[last][None]))
    return CubicSpline(keys, points)(np.arange(steps * fstep + 1))


def _all_segments(key_latents, transit, smooth, uniform, looped):
    """Interpolate every keypoint segment in ONE broadcasted pass.

    key_latents [S, *shape] -> frames [S*transit, *shape]: segment i runs
    from key i to key (i+1) (wrapping when looped, clamping otherwise).
    """
    steps = key_latents.shape[0]
    nxt = ((np.arange(steps) + 1) % steps if looped
           else np.minimum(np.arange(steps) + 1, steps - 1))
    za, zb = key_latents, key_latents[nxt]                    # [S, *shape]
    interp = lerp if uniform else slerp_np
    segs = interp(za, zb, transit, smooth=smooth)             # [T, S, *shape]
    segs = np.moveaxis(segs, 0, 1)                            # [S, T, *shape]
    return segs.reshape((steps * transit,) + key_latents.shape[1:])


def latent_anima(shape, frames, transit, key_latents=None, smooth: float = 0.5,
                 uniform: bool = False, cubic: bool = False, gauss: bool = False,
                 start_lat=None, seed=None, looped: bool = True,
                 verbose: bool = False):
    """A random-keypoint scalar or vector timeline of `frames` frames."""
    if key_latents is None:
        transit = int(max(1, min(frames // 2, transit)))
    steps = max(1, math.ceil(frames / transit))
    log = " timeline: %d steps by %d" % (steps, transit)

    if seed is None:
        seed = int((time.time() % 1) * 9999)
    rnd = np.random.RandomState(seed)

    if key_latents is None:
        key_latents = np.array([get_z(shape, rnd, uniform) for _ in range(steps)])
    if start_lat is not None:
        key_latents[0] = start_lat

    if transit == 1:
        latents = np.asarray(key_latents)
    elif cubic:
        latents = cublerp(key_latents, steps, transit, looped)
        log += ", cubic"
    else:
        body = _all_segments(np.asarray(key_latents, float), transit, smooth,
                             uniform, looped)
        latents = np.concatenate((key_latents[0][None], body))
    latents = np.asarray(latents)

    if gauss:
        lats_post = gaussian_filter(latents, [transit, 0, 0], mode="wrap")
        lats_post = (lats_post
                     / np.linalg.norm(lats_post, axis=-1, keepdims=True)
                     ) * math.sqrt(np.prod(shape))
        log += ", gauss"
        latents = lats_post

    if verbose:
        print(log)
    if latents.shape[0] > frames:
        latents = latents[1:]
    return latents


def motion_schedule(glob_steps, fstep, gen: str, scale=0.012, shift=10.0,
                    angle=0.8, shear=0.4, seed=None):
    """The 4-track motion schedule with amplitude coupling: scale
    ping-pongs (FFT) or zooms in (RGB); the shift, angle and shear
    amplitudes follow |scale - 1|.  Returns (m_scale [N,1], m_shift [N,2],
    m_angle [N,1], m_shear [N,1]) for N = glob_steps frames."""
    midp = 0.5
    if gen.upper() == "RGB":
        m_scale = latent_anima([1], glob_steps, fstep, uniform=True, cubic=True,
                               start_lat=[-0.3], seed=seed)
        m_scale = 1 + (m_scale + 0.3) * scale
    else:
        m_scale = latent_anima([1], glob_steps, fstep, uniform=True, cubic=True,
                               start_lat=[0.6], seed=seed)
        m_scale = 1 - (m_scale - 0.6) * scale
    m_shift = latent_anima([2], glob_steps, fstep, uniform=True, cubic=True,
                           start_lat=[midp, midp], seed=seed)
    m_angle = latent_anima([1], glob_steps, fstep, uniform=True, cubic=True,
                           start_lat=[midp], seed=seed)
    m_shear = latent_anima([1], glob_steps, fstep, uniform=True, cubic=True,
                           start_lat=[midp], seed=seed)
    m_shift = (midp - m_shift) * shift * abs(m_scale - 1) / scale
    m_angle = (midp - m_angle) * angle * abs(m_scale - 1) / scale
    m_shear = (midp - m_shear) * shear * abs(m_scale - 1) / scale
    return m_scale, m_shift, m_angle, m_shear
