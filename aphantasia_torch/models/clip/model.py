"""OpenAI-CLIP ViT towers as plain functions on tensors (counterpart of
aphantasia_tpu.models.clip.model).

Params are nested dicts of tensors in the JAX package's layout: every
linear weight is [in, out] and applied as `x @ W + b`, the merged qkv
projection gives the [rows, 3D] stream, and the patchify is a reshape and
a matmul.  LayerNorms run in float32; matmuls run in the dtype of the
activations (bf16 on the card by default, `cast_weights`).

The attention core is the hand-written CUDA kernel of ops/attention.py.
The vision tower always runs the flat [b*t, d] stream and the text tower
runs unpadded at t=77: the JAX package pads tokens (`_pad_tokens`,
`_padded_t`) and picks a flat or padded path (`flat_geometry`) only to fit
the TPU's (8, 128) tiles, and the CUDA kernel takes any token count.
Under APHANTASIA_FUSED_BLOCK=1 the vision blocks run as the fused
half-block kernels of ops/block.py where that geometry gate opens
(ViT-B/32), so the switch reaches the same models in both packages.

The ModifiedResNet towers are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from aphantasia_torch.ops.attention import attention_core, attention_core_flat
from aphantasia_torch.ops import block, ln


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    image_resolution: int
    vision_layers: Any          # int (ViT) or 4-tuple (ModifiedResNet)
    vision_width: int
    vision_patch_size: int      # 0 for ResNet
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        return (self.vision_width // 64 if self.is_vit
                else self.vision_width * 32 // 64)


CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig("ViT-B/32", 512, 224, 12, 768, 32),
    "ViT-B/16": CLIPConfig("ViT-B/16", 512, 224, 12, 768, 16),
    "ViT-L/14": CLIPConfig("ViT-L/14", 768, 224, 24, 1024, 14,
                           transformer_width=768, transformer_heads=12),
    "ViT-L/14@336px": CLIPConfig("ViT-L/14@336px", 768, 336, 24, 1024, 14,
                                 transformer_width=768, transformer_heads=12),
    "RN50": CLIPConfig("RN50", 1024, 224, (3, 4, 6, 3), 64, 0),
    "RN101": CLIPConfig("RN101", 512, 224, (3, 4, 23, 3), 64, 0),
    "RN50x4": CLIPConfig("RN50x4", 640, 288, (4, 6, 10, 6), 80, 0,
                         transformer_width=640, transformer_heads=10),
    "RN50x16": CLIPConfig("RN50x16", 768, 384, (6, 8, 18, 8), 96, 0,
                          transformer_width=768, transformer_heads=12),
    "RN50x64": CLIPConfig("RN50x64", 1024, 448, (3, 15, 36, 10), 128, 0,
                          transformer_width=1024, transformer_heads=16),
}

# sample-budget multipliers per model (constant-memory heuristic)
XMEM = {"ViT-B/16": 0.25, "ViT-L/14": 0.04, "RN50": 0.5, "RN50x4": 0.16,
        "RN50x16": 0.06, "RN50x64": 0.01, "RN101": 0.33}

# the models the port runs; the others wait for later slices (ROADMAP.md).
# ViT-L/14@336px runs at tower level (577 tokens, which the bf16 attention
# tiles take at any count); its CLI, illustra, is a later slice, and
# clip_fft does not offer it, as in the JAX package
PORTED_MODELS = ("ViT-B/32", "ViT-B/16", "ViT-L/14", "ViT-L/14@336px")


# ------------------------------------------------------------------ layers

def layer_norm(x, p, eps=1e-5):
    """Row LayerNorm in float32 with one-pass moments (E[x^2] - E[x]^2),
    as the JAX package computes it; returns x's dtype.

    With APHANTASIA_PALLAS_LN=1 an eligible LayerNorm (the flat [rows, D]
    stream of the vision blocks: D % 128 == 0, at least 1024 rows) runs the
    hand-written CUDA kernel pair of ops/ln.py on the card.  The variable
    is read at each call (the JAX package binds it at import, for its jit
    cache; here nothing is traced, so a process may switch it)."""
    if (os.environ.get("APHANTASIA_PALLAS_LN") == "1"
            and ln.eligible(x, p["g"])):
        return ln.layer_norm_fused(x, p["g"], p["b"], eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _linear(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def mha(x, p, n_heads, causal=False):
    """Multi-head self-attention over [B, T, D] with the merged-qkv
    layout (the text tower; `causal` is its only mask)."""
    qkv = _linear(x, p["in_w"], p["in_b"])                    # [B,T,3D]
    return _linear(attention_core(qkv, n_heads, causal), p["out_w"],
                   p["out_b"])


def mha_flat(x, p, n_heads, t):
    """mha over the flat sample-major stream [b*t, d]: the projections run
    on the flat rows; only the kernel sees the sample structure."""
    qkv = _linear(x, p["in_w"], p["in_b"])                    # [b*t,3D]
    return _linear(attention_core_flat(qkv, n_heads, t), p["out_w"],
                   p["out_b"])


def _mlp(x, p):
    h = quick_gelu(_linear(x, p["fc_w"], p["fc_b"]))
    return _linear(h, p["proj_w"], p["proj_b"])


def resblock_flat(x, p, n_heads, t):
    x = x + mha_flat(layer_norm(x, p["ln_1"]), p["attn"], n_heads, t)
    return x + _mlp(layer_norm(x, p["ln_2"]), p["mlp"])


def resblock(x, p, n_heads, causal=False):
    x = x + mha(layer_norm(x, p["ln_1"]), p["attn"], n_heads, causal)
    return x + _mlp(layer_norm(x, p["ln_2"]), p["mlp"])


def transformer_flat(x, blocks, n_heads, t):
    """The vision blocks over the flat stream.  With
    APHANTASIA_FUSED_BLOCK=1 (read at each call, as the JAX package reads
    it) and the JAX geometry gate open (`block.flat_geometry`: t = 50 of
    ViT-B/32, not ViT-B/16's 197 or ViT-L/14's 257), each block runs as the
    two fused half-block kernels of ops/block.py."""
    fused = (os.environ.get("APHANTASIA_FUSED_BLOCK") == "1"
             and block.flat_geometry(t, x.dtype) is not None)
    for p in blocks:
        x = (block.resblock_flat_fused if fused else resblock_flat)(
            x, p, n_heads, t)
    return x


def transformer(x, blocks, n_heads, causal=False):
    for p in blocks:
        x = resblock(x, p, n_heads, causal)
    return x


# ------------------------------------------------------------------ ViT

def vit_encode(params, cfg: CLIPConfig, x, dtype=torch.float32):
    """x: NCHW normalized images -> [N, embed_dim], on the flat stream."""
    p = cfg.vision_patch_size
    b, c, h, w = x.shape
    gh, gw = h // p, w // p
    x = x.to(dtype).reshape(b, c, gh, p, gw, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p)
    x = x @ params["conv"].to(dtype)                          # patchify
    d = x.shape[-1]
    cls = params["class_emb"].to(dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"].to(dtype)
    x = layer_norm(x, params["ln_pre"])
    t = x.shape[1]
    xf = transformer_flat(x.reshape(b * t, d), params["blocks"],
                          cfg.vision_heads, t)
    x = layer_norm(xf.reshape(b, t, d)[:, 0], params["ln_post"])
    return x @ params["proj"].to(dtype)


# ------------------------------------------------------------------ text

def text_encode_fn(params, cfg: CLIPConfig, tokens, dtype=torch.float32):
    t = params["text"]
    tokens = tokens.long()
    x = t["token_embedding"][tokens].to(dtype)
    x = x + t["positional_embedding"].to(dtype)
    x = transformer(x, t["blocks"], cfg.transformer_heads, causal=True)
    x = layer_norm(x, t["ln_final"])
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return x @ t["text_projection"].to(dtype)


# ------------------------------------------------------------------ public API

def _need_vit(cfg: CLIPConfig):
    if not cfg.is_vit:
        raise NotImplementedError(
            f"the ModifiedResNet tower ({cfg.name}) is not ported to "
            "aphantasia_torch yet; see ROADMAP.md")


def encode_image(params, cfg: CLIPConfig, images, dtype=torch.float32):
    """images: NCHW, already CLIP-normalized.  Returns [N, embed_dim]."""
    _need_vit(cfg)
    return vit_encode(params["visual"], cfg, images, dtype)


def encode_text(params, cfg: CLIPConfig, tokens, dtype=torch.float32):
    """tokens: int [N, context_length]."""
    return text_encode_fn(params, cfg, tokens, dtype)


def cast_weights(tree, dtype):
    """The param tree with every matmul weight in `dtype` (LayerNorm
    gains/biases stay float32), so a bf16 tower casts its weights once
    instead of at every call."""
    if isinstance(tree, dict):
        return {k: (v if k.startswith("ln") else cast_weights(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_weights(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ------------------------------------------------------------------ init

def _ln_init(d, dev):
    return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}


def _block_init(gen, d, dev, mlp_ratio=4):
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    attn_std = d ** -0.5
    fc_std = (2 * d) ** -0.5
    return {
        "ln_1": _ln_init(d, dev),
        "attn": {"in_w": attn_std * normal(d, 3 * d),
                 "in_b": torch.zeros(3 * d, device=dev),
                 "out_w": attn_std * normal(d, d),
                 "out_b": torch.zeros(d, device=dev)},
        "ln_2": _ln_init(d, dev),
        "mlp": {"fc_w": fc_std * normal(d, mlp_ratio * d),
                "fc_b": torch.zeros(mlp_ratio * d, device=dev),
                "proj_w": attn_std * normal(mlp_ratio * d, d),
                "proj_b": torch.zeros(d, device=dev)},
    }


def clip_init(generator: torch.Generator, cfg: CLIPConfig):
    """Random-weight CLIP with the exact architecture shapes (there are no
    checkpoints to download), on the generator's device, float32."""
    _need_vit(cfg)
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    d, p = cfg.vision_width, cfg.vision_patch_size
    g = cfg.image_resolution // p
    scale = d ** -0.5
    visual = {
        "conv": scale * normal(3 * p * p, d),
        "class_emb": scale * normal(d),
        "pos_emb": scale * normal(g * g + 1, d),
        "ln_pre": _ln_init(d, dev),
        "blocks": [_block_init(generator, d, dev)
                   for _ in range(cfg.vision_layers)],
        "ln_post": _ln_init(d, dev),
        "proj": scale * normal(d, cfg.embed_dim),
    }
    tw = cfg.transformer_width
    text = {
        "token_embedding": 0.02 * normal(cfg.vocab_size, tw),
        "positional_embedding": 0.01 * normal(cfg.context_length, tw),
        "blocks": [_block_init(generator, tw, dev)
                   for _ in range(cfg.transformer_layers)],
        "ln_final": _ln_init(tw, dev),
        "text_projection": tw ** -0.5 * normal(tw, cfg.embed_dim),
    }
    return {"visual": visual, "text": text,
            "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32,
                                        device=dev)}


def load_clip(name: str, weights_path: str | None = None,
              generator: torch.Generator | None = None):
    """(params, cfg) on the CPU.  `weights_path` (or APHANTASIA_CLIP_PT)
    names an OpenAI, open_clip or HuggingFace checkpoint, converted by
    models/clip/convert.py and checked against the model's shapes; without
    one the weights are random (shapes and FLOPs identical)."""
    from aphantasia_torch.weights import env_weights, warn_random
    if name not in PORTED_MODELS:
        raise NotImplementedError(
            f"CLIP model {name!r} is not ported to aphantasia_torch yet "
            f"(ported: {', '.join(PORTED_MODELS)}); see ROADMAP.md")
    cfg = CLIP_CONFIGS[name]
    weights_path = env_weights("clip", weights_path)
    if weights_path is not None:
        from aphantasia_torch.models.clip.convert import convert_checkpoint
        return convert_checkpoint(weights_path, expect_cfg=cfg), cfg
    warn_random(f"clip {name}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return clip_init(generator, cfg), cfg


def input_resolution(name: str) -> int:
    """CLIP input size, with the reference's fallbacks."""
    if name in CLIP_CONFIGS:
        return CLIP_CONFIGS[name].image_resolution
    return 288 if name == "RN50x4" else 384 if name == "RN50x16" else 224
