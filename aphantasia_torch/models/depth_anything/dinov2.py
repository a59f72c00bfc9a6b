"""The DINOv2 ViT trunk of Depth-Anything-V2 (counterpart of
aphantasia_tpu.models.depth_anything.dinov2): patch-14 embedding, class
token, position embeddings resized bicubically (half-pixel, no
antialias), pre-norm blocks with LayerScale, and the final LayerNorm on
every tapped layer.  The tree keeps the JAX layout (linear weights
[in, out], merged qkv).  Attention is `F.scaled_dot_product_attention`,
the counterpart of the JAX package's `jax.nn.dot_product_attention` (no
Pallas kernel there)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from aphantasia_torch.models.clip.model import layer_norm
from aphantasia_torch.ops.resize import resize_bicubic_halfpix


def _mlp(x, p):
    x = x @ p["fc1_w"].to(x.dtype) + p["fc1_b"].to(x.dtype)
    x = F.gelu(x, approximate="none")
    return x @ p["fc2_w"].to(x.dtype) + p["fc2_b"].to(x.dtype)


def _attn(x, p, n_heads):
    b, t, d = x.shape
    qkv = x @ p["qkv_w"].to(x.dtype) + p["qkv_b"].to(x.dtype)
    hd = d // n_heads
    q, k, v = (y.reshape(b, t, n_heads, hd).transpose(1, 2)
               for y in qkv.chunk(3, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v)
    o = o.transpose(1, 2).reshape(b, t, d)
    return o @ p["proj_w"].to(x.dtype) + p["proj_b"].to(x.dtype)


def _block(x, p, n_heads):
    x = x + p["ls1"].to(x.dtype) * _attn(layer_norm(x, p["ln_1"]), p["attn"],
                                         n_heads)
    return x + p["ls2"].to(x.dtype) * _mlp(layer_norm(x, p["ln_2"]), p["mlp"])


def interp_pos_emb(pos_emb, gh: int, gw: int):
    """The position embeddings [1 + g0*g0, D] of a square g0 grid resized
    to a gh x gw grid: `F.interpolate(mode='bicubic',
    align_corners=False)` without antialias, in float32; the class
    token's row as is."""
    cls, patch = pos_emb[:1], pos_emb[1:]
    g0 = int(round(patch.shape[0] ** 0.5))
    d = patch.shape[-1]
    if (gh, gw) == (g0, g0):
        return pos_emb
    grid = patch.float().reshape(g0, g0, d).permute(2, 0, 1)
    grid = resize_bicubic_halfpix(grid, (gh, gw))          # [D, gh, gw]
    grid = grid.permute(1, 2, 0).reshape(gh * gw, d).to(pos_emb.dtype)
    return torch.cat([cls, grid], dim=0)


def dinov2_features(params, x, n_heads: int, take_layers, patch: int = 14,
                    dtype=torch.float32):
    """x [N,3,H,W], ImageNet-normalized, H and W multiples of 14 -> the
    patch tokens [N, gh*gw, D] (class token stripped) of each layer in
    `take_layers`, each through the final LayerNorm."""
    n, c, h, w = x.shape
    gh, gw = h // patch, w // patch
    x = x.to(dtype).reshape(n, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(n, gh * gw, c * patch * patch)
    x = x @ params["patch_w"].to(dtype) + params["patch_b"].to(dtype)
    cls = params["cls_token"].to(dtype).expand(n, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + interp_pos_emb(params["pos_emb"], gh, gw).to(dtype)
    outs = []
    for i, blk in enumerate(params["blocks"]):
        x = _block(x, blk, n_heads)
        if i in take_layers:
            outs.append(x)
    fln = params.get("final_ln")
    if fln is not None:
        outs = [layer_norm(o, fln) for o in outs]
    return [o[:, 1:] for o in outs]


def dinov2_init(generator: torch.Generator, depth: int, dim: int,
                n_heads: int, patch: int = 14, img: int = 518):
    """A random trunk from `generator`, the JAX init's shapes and scales."""
    g0 = img // patch

    def randn(*shape, s=1.0):
        return s * torch.randn(shape, generator=generator)

    def ln():
        return {"g": torch.ones(dim), "b": torch.zeros(dim)}

    def blk():
        s = dim ** -0.5
        return {
            "ln_1": ln(),
            "attn": {"qkv_w": randn(dim, 3 * dim, s=s),
                     "qkv_b": torch.zeros(3 * dim),
                     "proj_w": randn(dim, dim, s=s),
                     "proj_b": torch.zeros(dim)},
            "ls1": torch.full((dim,), 1e-5),
            "ln_2": ln(),
            "mlp": {"fc1_w": randn(dim, 4 * dim, s=s),
                    "fc1_b": torch.zeros(4 * dim),
                    "fc2_w": randn(4 * dim, dim, s=s),
                    "fc2_b": torch.zeros(dim)},
            "ls2": torch.full((dim,), 1e-5),
        }
    return {
        "patch_w": randn(3 * patch * patch, dim, s=0.02),
        "patch_b": torch.zeros(dim),
        "cls_token": randn(dim, s=0.02),
        "pos_emb": randn(1 + g0 * g0, dim, s=0.02),
        "blocks": [blk() for _ in range(depth)],
        "final_ln": ln(),
    }
