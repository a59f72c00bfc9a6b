"""OpenAI-CLIP towers as plain functions on tensors (counterpart of
aphantasia_tpu.models.clip.model): the ViTs and the ModifiedResNets.

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
On the card the bf16 vision blocks run as the fused half-block kernels of
ops/block.py wherever the JAX geometry gate opens (ViT-B/32's t = 50) and
no model axis splits them; APHANTASIA_FUSED_BLOCK=1 takes that route on
every device and dtype (the CPU's plain versions included), so the switch
reaches the same models in both packages.

The ModifiedResNet towers (RN50 to RN50x64) run their convolutions as
`F.conv2d` in the channels-last layout (NHWC, the JAX tower's layout; the
JAX package computes them with `lax.conv_general_dilated`, outside any
Pallas kernel).  Their convolution weights are OIHW in this tree, where
the JAX tree holds HWIO: `convert.clip_params_from_numpy` turns the one
into the other.  The frozen BatchNorms fold their running statistics in
float32 at each call, as JAX's `_bn` does, so `cast_weights` leaves them
float32.  The attention pool queries with one token (the mean), so it
runs as a plain softmax over that token's score row: no atomics in its
backward, and a CUDA-graph replay repeats the eager step bit for bit.

Under a model axis (parallel/mesh.py) the transformer blocks of both
towers hold a rank's tensor-parallel shard (`shard_clip_params`): a group
of the attention heads (q, k and v each cut by heads, out_w by the same
heads' rows) and a slice of the MLP (fc_w by columns, proj_w by rows).
A block sees it from its weights' shapes: it enters each sharded product
through `copy_to_model` (the input's gradient summed over the model axis)
and leaves it through `reduce_from_model` (the partial products summed),
then adds the whole bias.  The attention kernel runs on the rank's heads.
The ResNet trunk and its attention pool stay whole.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from aphantasia_torch.ops.attention import attention_core, attention_core_flat
from aphantasia_torch.ops import block, ln
from aphantasia_torch.profiling import mark


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
    vision_heads_override: int = 0  # tiny test configurations

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.vision_heads_override:
            return self.vision_heads_override
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

# the models the port runs: every published configuration
PORTED_MODELS = tuple(CLIP_CONFIGS)


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


def model_split(p) -> int:
    """The model-axis size a block's weights are sharded over: 1 for a
    whole block, k when its in_w holds 3D/k of the 3D columns."""
    d = p["attn"]["out_w"].shape[1]
    return 3 * d // p["attn"]["in_w"].shape[1]


def _enter(x, k: int):
    """A sharded product's input (`copy_to_model`), or x when whole."""
    if k == 1:
        return x
    from aphantasia_torch.parallel.mesh import copy_to_model
    return copy_to_model(x)


def _leave(y, b):
    """A row-parallel product's partial outputs summed over the model axis
    (`reduce_from_model`), then its whole bias."""
    from aphantasia_torch.parallel.mesh import reduce_from_model
    return reduce_from_model(y) + b.to(y.dtype)


def mha(x, p, n_heads, causal=False, k=1):
    """Multi-head self-attention over [B, T, D] with the merged-qkv
    layout (the text tower; `causal` is its only mask).  `k` > 1: the
    weights hold this rank's n_heads / k heads of a model axis of k."""
    qkv = _linear(_enter(x, k), p["in_w"], p["in_b"])         # [B,T,3D/k]
    o = attention_core(qkv, n_heads // k, causal)
    if k == 1:
        return _linear(o, p["out_w"], p["out_b"])
    return _leave(o @ p["out_w"].to(o.dtype), p["out_b"])


def mha_flat(x, p, n_heads, t, k=1):
    """mha over the flat sample-major stream [b*t, d]: the projections run
    on the flat rows; only the kernel sees the sample structure.  In a
    captured graph the attention core sits between an "attn" mark and a
    "tower" mark (`profiling.mark`), so `CountedGraph.layer_ms()` gives
    its forward and backward as "attn" apart from the rest of the tower."""
    qkv = _linear(_enter(x, k), p["in_w"], p["in_b"])         # [b*t,3D/k]
    o = mark(attention_core_flat(mark(qkv, "attn"), n_heads // k, t),
             "tower")
    if k == 1:
        return _linear(o, p["out_w"], p["out_b"])
    return _leave(o @ p["out_w"].to(o.dtype), p["out_b"])


def _mlp(x, p, k=1):
    h = quick_gelu(_linear(_enter(x, k), p["fc_w"], p["fc_b"]))
    if k == 1:
        return _linear(h, p["proj_w"], p["proj_b"])
    return _leave(h @ p["proj_w"].to(h.dtype), p["proj_b"])


def resblock_flat(x, p, n_heads, t):
    k = model_split(p)
    x = x + mha_flat(layer_norm(x, p["ln_1"]), p["attn"], n_heads, t, k)
    return x + _mlp(layer_norm(x, p["ln_2"]), p["mlp"], k)


def resblock(x, p, n_heads, causal=False):
    k = model_split(p)
    x = x + mha(layer_norm(x, p["ln_1"]), p["attn"], n_heads, causal, k)
    return x + _mlp(layer_norm(x, p["ln_2"]), p["mlp"], k)


def fused_blocks(x, blocks, t) -> bool:
    """Whether `transformer_flat` runs the blocks as the fused half-block
    kernels of ops/block.py: only where the JAX geometry gate opens
    (`block.flat_geometry`: t = 50 of ViT-B/32, not ViT-B/16's 197 or
    ViT-L/14's 257).  There, by default, a bf16 stream on the card takes
    them unless a model axis splits the blocks (csrc/block.cu fuses whole
    products); APHANTASIA_FUSED_BLOCK=1 (read at each call, as the JAX
    package reads it) takes them on any device and dtype, and raises
    under a model axis."""
    if block.flat_geometry(t, x.dtype) is None:
        return False
    split = bool(blocks) and model_split(blocks[0]) > 1
    if os.environ.get("APHANTASIA_FUSED_BLOCK") == "1":
        if split:
            raise NotImplementedError(
                "APHANTASIA_FUSED_BLOCK=1 runs whole blocks (csrc/block.cu "
                "fuses the whole products); it does not take a model axis")
        return True
    return x.is_cuda and x.dtype == torch.bfloat16 and not split


def transformer_flat(x, blocks, n_heads, t):
    """The vision blocks over the flat stream, each as the two fused
    half-block kernels where `fused_blocks` says so, else unfused."""
    fused = fused_blocks(x, blocks, t)
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


# ------------------------------------------------------------------ ModifiedResNet

def _bn(x, p):
    """Frozen BatchNorm over NCHW: the running statistics folded in
    float32 into a scale and a shift (as JAX's `_bn`, in its order), then
    cast to the activations' dtype."""
    inv = torch.rsqrt(p["v"].float() + 1e-5)
    g = (p["g"] * inv).to(x.dtype)
    b = (p["b"] - p["m"] * p["g"] * inv).to(x.dtype)
    return x * g[:, None, None] + b[:, None, None]


def _conv(x, w, stride=1):
    """A convolution with the OIHW weight `w`: a 3x3 pads one pixel on
    every side (JAX's SAME at stride 1, and the OpenAI stem's explicit
    (1, 1) at stride 2, where SAME would pad (0, 1)); a 1x1 pads none."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2)


def _avgpool(x, k):
    """A VALID k-by-k window at stride k, its sum over k^2."""
    return F.avg_pool2d(x, k)


def bottleneck(x, p, stride):
    out = torch.relu(_bn(_conv(x, p["conv1_w"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2_w"]), p["bn2"]))
    if stride > 1:
        out = _avgpool(out, stride)          # before conv3, as in CLIP
    out = _bn(_conv(out, p["conv3_w"]), p["bn3"])
    if "down_conv_w" in p:
        idn = _avgpool(x, stride) if stride > 1 else x
        idn = _bn(_conv(idn, p["down_conv_w"]), p["down_bn"])
    else:
        idn = x
    return torch.relu(out + idn)


def attnpool(x, p, n_heads):
    """AttentionPool2d over an NCHW map: the mean token prepended to the
    h*w tokens (row-major (h, w), the order of JAX's NHWC reshape), the
    positional embedding added, and that one token attending to all.
    Scores and softmax in float32, the probabilities then in the
    activations' dtype, as `jax.nn.dot_product_attention` computes."""
    b, c = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)                          # [b, hw, c]
    x = torch.cat([x.mean(1, keepdim=True), x], dim=1)
    x = x + p["pos_emb"].to(x.dtype)
    hd = c // n_heads
    q = _linear(x[:, :1], p["q_w"], p["q_b"]).reshape(b, n_heads, 1, hd)
    k = _linear(x, p["k_w"], p["k_b"]).reshape(b, -1, n_heads, hd)
    v = _linear(x, p["v_w"], p["v_b"]).reshape(b, -1, n_heads, hd)
    k, v = k.transpose(1, 2), v.transpose(1, 2)               # [b, nh, t, hd]
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    o = torch.softmax(s, dim=-1).to(x.dtype) @ v              # [b, nh, 1, hd]
    return _linear(o.reshape(b, c), p["c_w"], p["c_b"])


def resnet_encode(params, cfg: CLIPConfig, x, dtype=torch.float32):
    """x: NCHW normalized images -> [N, embed_dim]; the activations in the
    channels-last layout."""
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    st = params["stem"]
    x = torch.relu(_bn(_conv(x, st["conv1_w"], stride=2), st["bn1"]))
    x = torch.relu(_bn(_conv(x, st["conv2_w"]), st["bn2"]))
    x = torch.relu(_bn(_conv(x, st["conv3_w"]), st["bn3"]))
    x = _avgpool(x, 2)
    for i, stage in enumerate(params["layers"]):
        for j, blk in enumerate(stage):
            x = bottleneck(x, blk, 2 if (i > 0 and j == 0) else 1)
    return attnpool(x, params["attnpool"], cfg.vision_heads)


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

def encode_image(params, cfg: CLIPConfig, images, dtype=torch.float32):
    """images: NCHW, already CLIP-normalized.  Returns [N, embed_dim]."""
    if cfg.is_vit:
        return vit_encode(params["visual"], cfg, images, dtype)
    return resnet_encode(params["visual"], cfg, images, dtype)


def encode_text(params, cfg: CLIPConfig, tokens, dtype=torch.float32):
    """tokens: int [N, context_length]."""
    return text_encode_fn(params, cfg, tokens, dtype)


def _float32_leaf(key: str) -> bool:
    """LayerNorm gains/biases and the BatchNorms' statistics (`bn1`..`bn3`,
    `down_bn`), which their layers use in float32."""
    return key.startswith(("ln", "bn", "down_bn"))


def cast_weights(tree, dtype):
    """The param tree with every matmul and convolution weight in `dtype`
    (the `_float32_leaf` dicts stay float32), so a bf16 tower casts its
    weights once instead of at every call; the convolution weights in the
    channels-last layout of the activations."""
    if isinstance(tree, dict):
        return {k: (v if _float32_leaf(k) else cast_weights(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_weights(v, dtype) for v in tree]
    if not tree.is_floating_point():
        return tree
    if tree.dim() == 4:
        return tree.to(dtype).contiguous(memory_format=torch.channels_last)
    return tree.to(dtype)


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


def _vit_visual_init(generator, cfg: CLIPConfig, dev):
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    d, p = cfg.vision_width, cfg.vision_patch_size
    g = cfg.image_resolution // p
    scale = d ** -0.5
    return {
        "conv": scale * normal(3 * p * p, d),
        "class_emb": scale * normal(d),
        "pos_emb": scale * normal(g * g + 1, d),
        "ln_pre": _ln_init(d, dev),
        "blocks": [_block_init(generator, d, dev)
                   for _ in range(cfg.vision_layers)],
        "ln_post": _ln_init(d, dev),
        "proj": scale * normal(d, cfg.embed_dim),
    }


def _bn_init(d, dev):
    return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev),
            "m": torch.zeros(d, device=dev), "v": torch.ones(d, device=dev)}


def _resnet_visual_init(generator, cfg: CLIPConfig, dev):
    """The JAX `_resnet_visual_init` tree, its convolutions OIHW."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def conv(cin, cout, k):
        return normal(cout, cin, k, k) * np.sqrt(2.0 / (k * k * cin))
    w = cfg.vision_width
    stem = {"conv1_w": conv(3, w // 2, 3), "bn1": _bn_init(w // 2, dev),
            "conv2_w": conv(w // 2, w // 2, 3), "bn2": _bn_init(w // 2, dev),
            "conv3_w": conv(w // 2, w, 3), "bn3": _bn_init(w, dev)}
    layers, inplanes = [], w
    for i, nb in enumerate(cfg.vision_layers):
        planes = w * 2 ** i
        stage = []
        for j in range(nb):
            blk = {"conv1_w": conv(inplanes, planes, 1),
                   "bn1": _bn_init(planes, dev),
                   "conv2_w": conv(planes, planes, 3),
                   "bn2": _bn_init(planes, dev),
                   "conv3_w": conv(planes, planes * 4, 1),
                   "bn3": _bn_init(planes * 4, dev)}
            if j == 0 and (i > 0 or inplanes != planes * 4):
                blk["down_conv_w"] = conv(inplanes, planes * 4, 1)
                blk["down_bn"] = _bn_init(planes * 4, dev)
            stage.append(blk)
            inplanes = planes * 4
        layers.append(stage)
    embed, spacial = w * 32, cfg.image_resolution // 32
    scale = embed ** -0.5
    attnp = {"pos_emb": scale * normal(spacial * spacial + 1, embed)}
    for n in "qkv":
        attnp[n + "_w"] = scale * normal(embed, embed)
        attnp[n + "_b"] = torch.zeros(embed, device=dev)
    attnp["c_w"] = scale * normal(embed, cfg.embed_dim)
    attnp["c_b"] = torch.zeros(cfg.embed_dim, device=dev)
    return {"stem": stem, "layers": layers, "attnpool": attnp}


def clip_init(generator: torch.Generator, cfg: CLIPConfig):
    """Random-weight CLIP with the exact architecture shapes (there are no
    checkpoints to download), on the generator's device, float32."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    visual = (_vit_visual_init if cfg.is_vit else _resnet_visual_init)(
        generator, cfg, dev)
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
