"""Tiling / padding as index maps (counterpart of aphantasia_tpu.ops.tile).

The cutout sampler folds the overscan pad into its gather through static
per-axis maps (padded coord -> source coord); the padded frame is never
materialized."""
from __future__ import annotations

import numpy as np


def tile_axis_map(length: int, pad_before: int, pad_after: int,
                  symm: bool = False) -> np.ndarray:
    """Index map for one axis: padded index -> source index (repeating
    tiles, or triangular reflection with `symm`)."""
    x = np.arange(-pad_before, length + pad_after, dtype=np.float64)
    minx, maxx = -0.5, length - 0.5
    rng = maxx - minx
    if symm:
        double_rng = 2 * rng
        mod = np.fmod(x - minx, double_rng)
        normed = np.where(mod < 0, mod + double_rng, mod)
        out = np.where(normed >= rng, double_rng - normed, normed) + minx
    else:
        out = np.remainder(x - minx, rng) + minx
    return out.astype(np.int64).astype(np.int32)


def pad_maps(hw, size, type: str = "centr"):
    """Per-axis index maps padding frame `hw` up to `size` ('centr' splits
    the pad evenly, 'side' pads after; 'symm' mirrors).  Returns
    (y_map [size[0]], x_map [size[1]])."""
    h, w = hw
    symm = "symm" in type.lower()
    maps = []
    for s, dim in zip(size, (h, w)):
        if "side" in type.lower():
            p0, p1 = 0, s - dim
        else:
            p0 = (s - dim) // 2
            p1 = s - dim - p0
        maps.append(tile_axis_map(dim, p0, p1, symm))
    return maps[0], maps[1]
