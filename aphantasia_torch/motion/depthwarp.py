"""The depth-driven 3D grid warp of the video CLI (counterpart of
aphantasia_tpu.motion.depthwarp).

A frame: a blur-lerped preview at the DA-V2 inference size (518 on the
short side, multiples of 14), the depth of the preview fused with the
mirrored estimate (`d * flip(d(flip(img)))`), resized back to the frame,
then two reflection-padded `grid_sample` passes: the sampling grid moved
towards or away from a moving origin in proportion to depth x strength,
then a lens distortion.  They run once a frame, outside the gradient.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from aphantasia_torch.ops.resize import resize_bicubic
from aphantasia_torch.ops.warp import base_grid, grid_sample


@functools.lru_cache(maxsize=8)
def _triangle(kernel_size: int, pow: float, device) -> torch.Tensor:
    """The normalised triangle taps [k], float32, once per device.
    Shared: never written to."""
    k = torch.abs(torch.linspace(-1.0, 1.0, kernel_size + 2)[1:-1])
    k = (1.0 - k) ** pow
    return (k / k.sum()).to(device)


def triangle_blur(x: torch.Tensor, kernel_size: int = 3,
                  pow: float = 1.0) -> torch.Tensor:
    """Separable triangle blur of [B,C,H,W] with reflect padding."""
    padding = (kernel_size - 1) // 2
    b, c, h, w = x.shape
    k = _triangle(kernel_size, float(pow), x.device).to(x.dtype)
    xx = x.reshape(b * c, 1, h, w)
    xx = F.pad(xx, (padding, padding, padding, padding), mode="reflect")
    xx = F.conv2d(xx, k.reshape(1, 1, 1, kernel_size))
    xx = F.conv2d(xx, k.reshape(1, 1, kernel_size, 1))
    return xx.reshape(b, c, h, w)


def grid_warp(img: torch.Tensor, depth: torch.Tensor, strength, centre,
              midpoint, dlens: float = 0.05) -> torch.Tensor:
    """Depth-displaced sampling, then the lens distortion.
    img [1,C,H,W]; depth [1,H,W] in [0,1]; centre (dX, dY), the origin in
    [-1, 1]; midpoint (dZ) a scalar; either may be tensors."""
    h, w = img.shape[-2:]
    grid = base_grid(h, w, device=img.device)                  # [h,w,2] xy
    c = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                     device=img.device) for v in centre])
    d = c - grid
    d_sum = depth[0]
    d_sum = d_sum - torch.max(d_sum) * midpoint
    warped = grid + d * d_sum[..., None] * strength
    img = grid_sample(img, warped[None], padding="reflection")
    lens = torch.sqrt(torch.sum(d ** 2, dim=-1))
    warped = grid + d * lens[..., None] * strength * dlens
    return grid_sample(img, warped[None], padding="reflection")


def depth_dims(size) -> tuple:
    """The DA-V2 inference size of a frame: 518 on the short side, both
    sides cut to multiples of 14."""
    h, w = size
    res = 518
    dim = [res, int(res * w / h)] if h < w else [int(res * h / w), res]
    return tuple(x - x % 14 for x in dim)


def depth_preview(rgb: torch.Tensor, size) -> torch.Tensor:
    """The blur-lerped, inference-sized preview of a [0,1] RGB frame."""
    return resize_bicubic(rgb + 0.5 * (triangle_blur(rgb, 5, 2.0) - rgb),
                          depth_dims(size))


def mirror_fused_depth(infer_any, preview: torch.Tensor) -> torch.Tensor:
    """`d * flip(d(flip(img)))` as ONE batched forward of the preview and
    its mirror (the per-sample min-max of `InferDepthAny` keeps it equal
    to two calls).  Returns [1,1,hd,wd]."""
    pair = infer_any(torch.cat([preview, torch.flip(preview, (-1,))], dim=0))
    return pair[0:1] * torch.flip(pair[1:2], (-1,))


def depthwarp(img_t, img, infer_any, strength=0.0, centre=(0.0, 0.0),
              midpoint=0.5, save_path=None, save_num=0, dlens=0.05):
    """The whole per-frame depth warp in one call, for scripts and tests
    (the CLI runs its pieces split between the frame step and the depth
    forward): img_t is the parameter-space frame to warp, img its [0,1]
    RGB preview; with `save_path` the fused depth is written as
    `%05d.jpg`."""
    h, w = img.shape[-2:]
    depth = mirror_fused_depth(infer_any, depth_preview(img, (h, w)))
    depth = resize_bicubic(depth, (h, w))
    if save_path is not None:
        from aphantasia_torch.io.media import img_save
        arr = depth[0, 0].detach().cpu().numpy()
        img_save(os.path.join(save_path, "%05d.jpg" % save_num),
                 np.stack([arr] * 3, -1))
    return grid_warp(img_t, depth[0], strength, centre, midpoint, dlens)


def depth_transform(img_t, deptha, depthX=0.0, scale=1.0, shift=(0, 0),
                    colors=1.0, depth_dir=None, save_num=0):
    """The motion schedule mapped to the warp origin: dX, dY from the
    pixel shift, dZ = 0.5 + 32 (scale - 1); then `depthwarp` of img_t by
    the depth of its color-headed image."""
    from aphantasia_torch.params.color import to_valid_rgb
    if not isinstance(scale, float):
        scale = float(np.asarray(scale).ravel()[0])
    size = img_t.shape[-2:]
    dx = 100.0 * float(shift[0]) / size[1]
    dy = 100.0 * float(shift[1]) / size[0]
    dz = 0.5 + 32.0 * (scale - 1.0)
    img = to_valid_rgb(img_t, colors=colors)
    return depthwarp(img_t, img, deptha, float(depthX), (dx, dy), dz,
                     save_path=depth_dir, save_num=save_num)
