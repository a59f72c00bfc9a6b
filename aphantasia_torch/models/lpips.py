"""LPIPS perceptual distance with a VGG16 backbone (counterpart of
aphantasia_tpu.models.lpips), the loss of `--sync`: VGG16's relu1_2, 2_2,
3_3, 4_3 and 5_3 features, unit-normalised over channels, squared
differences through non-negative 1x1 "lin" heads, averaged over space and
summed over the five taps.

Params are {"convs": [{"w" OIHW, "b"}] x 13, "lins": [[C, 1]] x 5} in
float32: torch's own convolution layout, so torchvision `features.*`
tensors load as they are (`lpips_load`).  The JAX package keeps HWIO
(`convert.lpips_params_from_numpy` transposes).  Without a checkpoint the
weights are random, which keeps the term differentiable and shaped as the
real one.  The convolutions and pools are `F.conv2d` and `F.max_pool2d`
(cuDNN on the card; the JAX package's XLA convolutions, no Pallas kernel).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
# the features after the last ReLU of each block (torchvision indices
# 3, 8, 15, 22, 29)
TAP_CHANNELS = [64, 128, 256, 512, 512]
_TAPS = {1, 3, 6, 9, 12}           # the conv indices whose ReLU is a tap

_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


@functools.lru_cache(maxsize=8)
def _shift_scale(device):
    """_SHIFT and _SCALE as [1,3,1,1] tensors, once per device.  Shared:
    never written to."""
    return tuple(torch.as_tensor(v, device=device)[None, :, None, None]
                 for v in (_SHIFT, _SCALE))


def lpips_init(generator: torch.Generator):
    """Random weights on the generator's device: He-normal convolutions,
    zero biases, |randn| / C heads."""
    dev = generator.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    convs = []
    cin = 3
    for v in VGG_CFG:
        if v == "M":
            continue
        convs.append({"w": randn(v, cin, 3, 3) * np.sqrt(2.0 / (9 * cin)),
                      "b": torch.zeros((v,), device=dev)})
        cin = v
    lins = [torch.abs(randn(c, 1)) / c for c in TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


def lpips_get(generator: torch.Generator, path: str | None = None):
    """LPIPS params on the generator's device from the explicit path, else
    APHANTASIA_LPIPS_PT, else a random init with a loud warning.  `path`
    is one .pt or .npz holding both the torchvision VGG16 `features.*`
    tensors and the lpips `lin*.model.1.weight` heads."""
    from aphantasia_torch.weights import env_weights, warn_random
    path = env_weights("lpips", path)
    if path:
        if path.endswith(".npz"):
            sd = dict(np.load(path))
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        vgg = {k: v for k, v in sd.items() if k.startswith("features.")}
        lin = {k: v for k, v in sd.items() if k.startswith("lin")}
        return lpips_load(vgg, lin, generator.device)
    warn_random("lpips VGG16+linear heads")
    return lpips_init(generator)


def lpips_load(vgg_state, lin_state, device="cpu"):
    """torchvision VGG16 `features` weights (OIHW) and lpips lin weights
    ([1,C,1,1]), as tensors or numpy arrays -> LPIPS params."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    convs = []
    idx = 0
    for v in VGG_CFG:
        if v == "M":
            idx += 1
            continue
        convs.append({"w": t(vgg_state[f"features.{idx}.weight"]),
                      "b": t(vgg_state[f"features.{idx}.bias"])})
        idx += 2  # conv + relu
    lins = [t(lin_state[f"lin{i}.model.1.weight"])[0, :, 0, 0][:, None]
            for i in range(len(TAP_CHANNELS))]
    return {"convs": convs, "lins": lins}


def _vgg_features(params, x):
    """x: NCHW in VGG input space -> the five tap activations.  The last
    pool's output feeds no tap and is skipped (a 1-pixel map cannot be
    pooled, where XLA gives an empty one)."""
    taps = []
    ci = 0
    for v in VGG_CFG[:-1]:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        p = params["convs"][ci]
        x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
        if ci in _TAPS:
            taps.append(x)
        ci += 1
    return taps


def _unit_norm(x, eps=1e-10):
    """Unit norm over the channels (dim 1 of NCHW)."""
    return x / torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True) + eps)


def lpips_apply(params, x, y, normalize: bool = True):
    """Perceptual distance [N] between NCHW images; `normalize` expects
    [0,1] inputs (`lpips.LPIPS.forward(..., normalize=True)`)."""
    if normalize:
        x = 2.0 * x - 1.0
        y = 2.0 * y - 1.0
    shift, scale = _shift_scale(x.device)
    fx = _vgg_features(params, (x - shift) / scale)
    fy = _vgg_features(params, (y - shift) / scale)
    total = 0.0
    for tx, ty, lin in zip(fx, fy, params["lins"]):
        d = (_unit_norm(tx) - _unit_norm(ty)) ** 2
        d = d.mean(dim=(2, 3))                      # spatial average
        total = total + (d @ torch.abs(lin))[..., 0]
    return total
