"""The taming-transformers VQGAN decoder (taming/modules/diffusionmodules/
model.py, `Decoder`), plain, from a taming state dict: conv_in, the
middle ResnetBlock / AttnBlock / ResnetBlock, then from the coarsest level
up its ResnetBlocks (each followed by an AttnBlock where the level has
them) and a nearest 2x upsample and conv, then GroupNorm, swish and
conv_out; the image is (x + 1) / 2 clamped to [0, 1].  As the reference
notebook decodes a latent, `post_quant_conv` is not applied."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import REFERENCE


def _conv(x, sd, prefix, q):
    w = sd[prefix + ".weight"]
    return F.conv2d(q(x), q(w), sd[prefix + ".bias"],
                    padding=w.shape[-1] // 2)


def _norm(x, sd, prefix):
    return F.group_norm(x, 32 if x.shape[1] >= 32 else x.shape[1],
                        sd[prefix + ".weight"], sd[prefix + ".bias"], 1e-6)


def _res(x, sd, prefix, q):
    h = _conv(F.silu(_norm(x, sd, prefix + ".norm1")), sd, prefix + ".conv1",
              q)
    h = _conv(F.silu(_norm(h, sd, prefix + ".norm2")), sd, prefix + ".conv2",
              q)
    if prefix + ".nin_shortcut.weight" in sd:
        x = _conv(x, sd, prefix + ".nin_shortcut", q)
    return x + h


def _attn(x, sd, prefix, q):
    n, c, h, w = x.shape
    hn = _norm(x, sd, prefix + ".norm")
    qq = _conv(hn, sd, prefix + ".q", q).reshape(n, c, h * w).transpose(1, 2)
    kk = _conv(hn, sd, prefix + ".k", q).reshape(n, c, h * w)
    vv = _conv(hn, sd, prefix + ".v", q).reshape(n, c, h * w)
    a = torch.softmax((q(qq) @ q(kk)) * c ** -0.5, dim=-1)
    out = (q(vv) @ q(a).transpose(1, 2)).reshape(n, c, h, w)
    return x + _conv(out, sd, prefix + ".proj_out", q)


def decode(sd, dec: dict, z, prec=REFERENCE):
    """z [1, z_channels, h, w] -> image [1, 3, 16h, 16w] in [0, 1]; the
    products in the precision's `low` rounding (the program's decoder is
    bf16 on the card)."""
    q = prec.lo
    levels = len(dec["ch_mult"])
    x = _conv(z, sd, "decoder.conv_in", q)
    x = _res(x, sd, "decoder.mid.block_1", q)
    x = _attn(x, sd, "decoder.mid.attn_1", q)
    x = _res(x, sd, "decoder.mid.block_2", q)
    for level in reversed(range(levels)):
        for j in range(dec["num_res_blocks"] + 1):
            x = _res(x, sd, f"decoder.up.{level}.block.{j}", q)
            if f"decoder.up.{level}.attn.{j}.norm.weight" in sd:
                x = _attn(x, sd, f"decoder.up.{level}.attn.{j}", q)
        if level:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = _conv(x, sd, f"decoder.up.{level}.upsample.conv", q)
    x = _conv(F.silu(_norm(x, sd, "decoder.norm_out")), sd,
              "decoder.conv_out", q)
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
