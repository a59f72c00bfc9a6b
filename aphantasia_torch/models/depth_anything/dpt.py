"""The DPT depth head and the whole Depth-Anything-V2 model (counterpart
of aphantasia_tpu.models.depth_anything.dpt): multi-scale reassembly of
four tapped DINOv2 layers, top-down feature fusion, the output convolutions;
and `InferDepthAny`, the inference wrapper (ImageNet normalization, model,
per-sample min-max).

The convolutions run as `F.conv2d` (cuDNN on the card) in NCHW with OIHW
weights, where the JAX tree is NHWC/HWIO; the two transposed convolutions
keep torch's `ConvTranspose2d` layout [in, out, kh, kw], so
`F.conv_transpose2d` is the JAX package's flipped-kernel dilated
convolution.  The traps the JAX code records hold here too: the fusion and
head resizes are bilinear with align_corners=True (dense matrices), and
the stride-2 down convolution pads (1, 1).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from aphantasia_torch.models.depth_anything.dinov2 import (
    dinov2_features, dinov2_init)
from aphantasia_torch.ops.resize import linear_axis_matrix


@dataclasses.dataclass(frozen=True)
class DAV2Config:
    name: str
    dim: int
    depth: int
    n_heads: int
    take_layers: tuple
    out_channels: tuple
    features: int


DAV2_CONFIGS = {
    "s": DAV2Config("s", 384, 12, 6, (2, 5, 8, 11), (48, 96, 192, 384), 64),
    "b": DAV2Config("b", 768, 12, 12, (2, 5, 8, 11), (96, 192, 384, 768), 128),
    "l": DAV2Config("l", 1024, 24, 16, (4, 11, 17, 23), (256, 512, 1024, 1024),
                    256),
}


def _conv(x, w, b=None, stride: int = 1, padding=None):
    """NCHW convolution with an OIHW weight; the default padding is JAX's
    SAME at stride 1 (k // 2 for the odd kernels of the head)."""
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def _conv_transpose(x, w, b=None, stride: int = 2):
    """torch `ConvTranspose2d(..., stride, padding=0)`, w [in, out, kh,
    kw]."""
    return F.conv_transpose2d(x, w.to(x.dtype),
                              None if b is None else b.to(x.dtype),
                              stride=stride)


def _resize_align(x, oh: int, ow: int):
    """NCHW bilinear resize with align_corners=True, as two dense matrix
    products in x's dtype."""
    h, w = x.shape[-2:]
    wy = linear_axis_matrix(oh, h, x.device).to(x.dtype)
    wx = linear_axis_matrix(ow, w, x.device).to(x.dtype)
    return torch.matmul(torch.matmul(wy, x), wx.t())


def _rcu(x, p):
    """ResidualConvUnit."""
    out = _conv(F.relu(x), p["conv1_w"], p["conv1_b"])
    out = _conv(F.relu(out), p["conv2_w"], p["conv2_b"])
    return x + out


def _fusion(x, skip, p, size):
    """FeatureFusionBlock: refine the skip and add it, refine, resize to
    `size` (the next level's), project."""
    if skip is not None:
        x = x + _rcu(skip, p["rcu1"])
    x = _rcu(x, p["rcu2"])
    x = _resize_align(x, *size)
    return _conv(x, p["out_w"], p["out_b"])


def dav2_apply(params, cfg: DAV2Config, x, dtype=torch.float32):
    """x [N,3,H,W], ImageNet-normalized, H and W multiples of 14 -> the raw
    depth [N,1,H,W] (before the min-max)."""
    n, _, h, w = x.shape
    gh, gw = h // 14, w // 14
    feats = dinov2_features(params["backbone"], x, cfg.n_heads,
                            set(cfg.take_layers), dtype=dtype)
    hp = params["head"]
    pyramid = []
    for i, f in enumerate(feats):
        f = f @ hp["proj_w"][i].to(f.dtype) + hp["proj_b"][i].to(f.dtype)
        f = f.reshape(n, gh, gw, -1).permute(0, 3, 1, 2)
        if i == 0:
            f = _conv_transpose(f, hp["up4_w"], hp["up4_b"], stride=4)
        elif i == 1:
            f = _conv_transpose(f, hp["up2_w"], hp["up2_b"])
        elif i == 3:
            f = _conv(f, hp["down_w"], hp["down_b"], stride=2, padding=1)
        pyramid.append(f)
    scratch = [_conv(f, hp["scratch_w"][i]) for i, f in enumerate(pyramid)]
    path = _fusion(scratch[3], None, hp["fusion"][3], scratch[2].shape[-2:])
    path = _fusion(path, scratch[2], hp["fusion"][2], scratch[1].shape[-2:])
    path = _fusion(path, scratch[1], hp["fusion"][1], scratch[0].shape[-2:])
    path = _fusion(path, scratch[0], hp["fusion"][0],
                   (2 * scratch[0].shape[-2], 2 * scratch[0].shape[-1]))
    out = _conv(path, hp["out1_w"], hp["out1_b"])
    out = _resize_align(out, h, w)
    out = F.relu(_conv(out, hp["out2_w"], hp["out2_b"]))
    out = F.relu(_conv(out, hp["out3_w"], hp["out3_b"]))
    return out[:, :1]


def _conv_init(gen, kh, kw, cin, cout, transposed=False):
    shape = (cin, cout, kh, kw) if transposed else (cout, cin, kh, kw)
    return torch.randn(shape, generator=gen) * np.sqrt(2.0 / (kh * kw * cin))


def dav2_init(generator: torch.Generator, cfg: DAV2Config):
    """A random model from `generator`, the JAX init's shapes and scales
    in the port's layouts."""
    backbone = dinov2_init(generator, cfg.depth, cfg.dim, cfg.n_heads)
    f, oc, g = cfg.features, cfg.out_channels, generator

    def zeros(k):
        return torch.zeros(k)

    def rcu():
        return {"conv1_w": _conv_init(g, 3, 3, f, f), "conv1_b": zeros(f),
                "conv2_w": _conv_init(g, 3, 3, f, f), "conv2_b": zeros(f)}
    head = {
        "proj_w": [cfg.dim ** -0.5 * torch.randn((cfg.dim, oc[i]),
                                                 generator=g)
                   for i in range(4)],
        "proj_b": [zeros(oc[i]) for i in range(4)],
        "up4_w": _conv_init(g, 4, 4, oc[0], oc[0], transposed=True),
        "up4_b": zeros(oc[0]),
        "up2_w": _conv_init(g, 2, 2, oc[1], oc[1], transposed=True),
        "up2_b": zeros(oc[1]),
        "down_w": _conv_init(g, 3, 3, oc[3], oc[3]),
        "down_b": zeros(oc[3]),
        "scratch_w": [_conv_init(g, 3, 3, oc[i], f) for i in range(4)],
        "fusion": [{"rcu1": rcu(), "rcu2": rcu(),
                    "out_w": _conv_init(g, 1, 1, f, f), "out_b": zeros(f)}
                   for _ in range(4)],
        "out1_w": _conv_init(g, 3, 3, f, f // 2),
        "out1_b": zeros(f // 2),
        "out2_w": _conv_init(g, 3, 3, f // 2, 32),
        "out2_b": zeros(32),
        "out3_w": _conv_init(g, 1, 1, 32, 1),
        "out3_b": zeros(1),
    }
    return {"backbone": backbone, "head": head}


_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=8)
def _imagenet(device):
    """ImageNet mean and std as [1,3,1,1] tensors, once per device.
    Shared: never written to."""
    return tuple(torch.as_tensor(v, device=device)[None, :, None, None]
                 for v in (_IMAGENET_MEAN, _IMAGENET_STD))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class InferDepthAny:
    """ImageNet normalization -> model -> per-sample min-max.  `modtype`
    's', 'b' or 'l' (its first letter; anything else is 'b'); `params` a
    port tree (e.g. from `convert_hf_dav2`), else the checkpoint that
    APHANTASIA_DAV2_PT names, else random weights from `generator`
    (seed 0 by default), on `device`."""

    def __init__(self, modtype: str = "b", params=None,
                 generator: torch.Generator | None = None,
                 dtype=torch.float32, device="cpu"):
        self.cfg = DAV2_CONFIGS.get(modtype[0].lower(), DAV2_CONFIGS["b"])
        if params is None:
            from aphantasia_torch.weights import env_weights, warn_random
            path = env_weights("dav2")
            if path:
                from aphantasia_torch.models.depth_anything.convert import (
                    convert_hf_dav2)
                params = convert_hf_dav2(path)
            else:
                warn_random("dav2 Depth-Anything-V2")
                params = dav2_init(generator or torch.Generator().manual_seed(0),
                                   self.cfg)
        self.params = _to(params, torch.device(device))
        self.dtype = dtype

    @staticmethod
    def apply(params, cfg, image, dtype=torch.float32):
        """image [N,3,H,W] in [0,1] -> [N,1,H,W] float32, each sample
        min-maxed to [0,1] on its own (so the mirror pair may share one
        forward)."""
        mean, std = _imagenet(image.device)
        depth = dav2_apply(params, cfg, (image - mean) / std,
                           dtype=dtype).float()
        dmin = depth.amin(dim=(-3, -2, -1), keepdim=True)
        dmax = depth.amax(dim=(-3, -2, -1), keepdim=True)
        return (depth - dmin) / (dmax - dmin + 1e-12)

    @torch.no_grad()
    def __call__(self, image):
        return InferDepthAny.apply(self.params, self.cfg, image, self.dtype)
