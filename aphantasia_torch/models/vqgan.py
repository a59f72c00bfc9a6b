"""The taming-transformers VQGAN decoder (counterpart of
aphantasia_tpu.models.vqgan): conv_in -> mid (ResnetBlock, AttnBlock,
ResnetBlock) -> per level ResnetBlocks, each followed by its AttnBlock
where the level has them, and a nearest-2x upsample conv -> GroupNorm ->
swish -> conv_out, then (x + 1) / 2 clamped to [0, 1].  The trainable
state is a latent z [1, z_channels, H/f, W/f]; the decoder is frozen.

Layout NCHW with OIHW weights (the JAX package's NHWC/HWIO tree converts
with `convert.vqgan_params_from_numpy`; taming checkpoints are OIHW and
load directly, `convert_taming`).

Precision, as in the JAX decode: the convolutions and the attention
products run in the compute dtype; the GroupNorm moments and affine run in
float32 and are cast back; the attention scores are softmaxed in float32;
the image is clamped in float32.  `VQGANParameterizer`'s compute dtype
"auto" is bf16 on the card (weights and activations; the JAX package's
TPU default) unless APHANTASIA_DECODE_F32=1, and float32 on the CPU.

The decoder's tensors do not require grad, so a step's backward computes
the latent's gradient only.  Its attention is a plain float32 softmax over
a batched product (the JAX package's is not a Pallas kernel either): its
backward has no atomics, so a captured step replays bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    name: str
    z_channels: int = 256
    ch: int = 128
    ch_mult: tuple = (1, 1, 2, 2, 4)   # f16
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    out_ch: int = 3

    @property
    def f(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


VQGAN_CONFIGS = {
    "imagenet_f16_1024": VQGANConfig("imagenet_f16_1024"),
    "imagenet_f16_16384": VQGANConfig("imagenet_f16_16384"),
    "gumbel_f8_8192": VQGANConfig("gumbel_f8_8192", ch_mult=(1, 1, 2, 4),
                                  attn_resolutions=(32,)),
}


class _GroupNorm(torch.autograd.Function):
    """GroupNorm with its moments and affine in float32, cast back to the
    input's dtype.  The forward's moments are one `var_mean` over each
    group's channels and pixels, which the card splits over many blocks
    (`F.group_norm`'s moments kernel gives each of a decoder's 32 groups,
    up to 1.2M elements, one block, and took half the bf16 decode's
    time); the backward is PyTorch's own GroupNorm backward from the
    saved moments (float32), one pass where autograd through the forward's
    pieces would take many."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float):
        n, c, h, w = x.shape
        xf = x.float().reshape(n, groups, c // groups, h * w)
        var, mu = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
        rstd = torch.rsqrt(var + eps)
        y = torch.addcmul(beta.reshape(1, groups, -1, 1), xf - mu,
                          rstd * gamma.reshape(1, groups, -1, 1))
        ctx.save_for_backward(x, gamma, mu.reshape(n, groups),
                              rstd.reshape(n, groups))
        ctx.groups = groups
        return y.reshape(n, c, h, w).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, rstd = ctx.saved_tensors
        n, c, h, w = x.shape
        dx, dgamma, dbeta = torch.ops.aten.native_group_norm_backward(
            dy.float(), x.float(), mu, rstd, gamma, n, c, h * w, ctx.groups,
            list(ctx.needs_input_grad[:3]))
        return (None if dx is None else dx.to(x.dtype), dgamma, dbeta,
                None, None)


def _group_norm(x, p, groups=32, eps=1e-6):
    return _GroupNorm.apply(x, p["g"], p["b"], min(groups, x.shape[1]), eps)


def _conv(x, p):
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], p["b"], padding=k // 2)


def _swish(x):
    return F.silu(x)


def _resnet_block(x, p):
    h = _conv(_swish(_group_norm(x, p["norm1"])), p["conv1"])
    h = _conv(_swish(_group_norm(h, p["norm2"])), p["conv2"])
    if "nin" in p:
        x = _conv(x, p["nin"])
    return x + h


def _attn_block(x, p):
    n, c, h, w = x.shape
    hn = _group_norm(x, p["norm"])
    q = _conv(hn, p["q"]).reshape(n, c, h * w).transpose(1, 2)
    k = _conv(hn, p["k"]).reshape(n, c, h * w)
    v = _conv(hn, p["v"]).reshape(n, c, h * w)
    attn = torch.softmax(torch.bmm(q, k).float() * (c ** -0.5),
                         dim=-1).to(x.dtype)                # [n, q, k]
    out = torch.bmm(v, attn.transpose(1, 2)).reshape(n, c, h, w)
    return x + _conv(out, p["proj"])


def _upsample(x, p):
    n, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
    return _conv(x.reshape(n, c, 2 * h, 2 * w), p)


def vqgan_decode(params, cfg: VQGANConfig, z, use_post_quant: bool = False):
    """z [1, z_channels, h, w] -> image [1, 3, H, W] float32 in [0, 1],
    computed in the dtype of `params`' convolutions (`cast_decoder`).

    As the reference notebook's decode: the decoder alone, with no
    post_quant_conv, then (x + 1) / 2; `use_post_quant=True` applies
    post_quant_conv first (taming's `VQModel.decode`, for quantized
    codebook latents).  Each level's blocks interleave with its
    attentions: block i, then attention i."""
    x = z.to(params["conv_in"]["w"].dtype)
    if use_post_quant:
        x = _conv(x, params["post_quant"])
    x = _conv(x, params["conv_in"])
    mid = params["mid"]
    x = _resnet_block(x, mid["block1"])
    x = _attn_block(x, mid["attn"])
    x = _resnet_block(x, mid["block2"])
    for level in reversed(range(len(cfg.ch_mult))):
        lev = params["up"][level]
        attns = lev.get("attns", [])
        for i, blk in enumerate(lev["blocks"]):
            x = _resnet_block(x, blk)
            if i < len(attns):
                x = _attn_block(x, attns[i])
        if level != 0:
            x = _upsample(x, lev["upsample"])
    x = _conv(_swish(_group_norm(x, params["norm_out"])), params["conv_out"])
    return torch.clamp(((x + 1.0) / 2.0).float(), 0.0, 1.0)


def cast_decoder(params, dtype):
    """The decoder tree with its convolutions (weights and biases) in
    `dtype`; the GroupNorm affines stay float32."""
    def walk(t, norm=False):
        if isinstance(t, dict):
            return {k: walk(v, norm or k.startswith("norm"))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, norm) for v in t]
        return t if norm else t.to(dtype)
    return walk(params)


def _conv_init(gen, kh, kw, cin, cout):
    fan = kh * kw * cin
    return {"w": torch.randn((cout, cin, kh, kw), generator=gen,
                             device=gen.device) * float(np.sqrt(2.0 / fan)),
            "b": torch.zeros((cout,), device=gen.device)}


def _norm_init(c, device):
    return {"g": torch.ones((c,), device=device),
            "b": torch.zeros((c,), device=device)}


def vqgan_init(generator: torch.Generator, cfg: VQGANConfig):
    """A random decoder of the JAX `vqgan_init`'s structure (He-normal
    convolutions, unit GroupNorms; one attention a res block at the
    coarsest level, as the real checkpoints carry), on the generator's
    device."""
    g, dev = generator, generator.device
    block_in = cfg.ch * cfg.ch_mult[-1]

    def res_block(cin, cout):
        p = {"norm1": _norm_init(cin, dev),
             "conv1": _conv_init(g, 3, 3, cin, cout),
             "norm2": _norm_init(cout, dev),
             "conv2": _conv_init(g, 3, 3, cout, cout)}
        if cin != cout:
            p["nin"] = _conv_init(g, 1, 1, cin, cout)
        return p

    def attn_block(c):
        return {"norm": _norm_init(c, dev),
                "q": _conv_init(g, 1, 1, c, c), "k": _conv_init(g, 1, 1, c, c),
                "v": _conv_init(g, 1, 1, c, c),
                "proj": _conv_init(g, 1, 1, c, c)}

    params = {
        "post_quant": _conv_init(g, 1, 1, cfg.z_channels, cfg.z_channels),
        "conv_in": _conv_init(g, 3, 3, cfg.z_channels, block_in),
        "mid": {"block1": res_block(block_in, block_in),
                "attn": attn_block(block_in),
                "block2": res_block(block_in, block_in)},
    }
    cur = block_in
    ups = [None] * len(cfg.ch_mult)
    for level in reversed(range(len(cfg.ch_mult))):
        cout = cfg.ch * cfg.ch_mult[level]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(res_block(cur, cout))
            cur = cout
        lev = {"blocks": blocks}
        if cfg.attn_resolutions and level == len(cfg.ch_mult) - 1:
            lev["attns"] = [attn_block(cur)
                            for _ in range(cfg.num_res_blocks + 1)]
        if level != 0:
            lev["upsample"] = _conv_init(g, 3, 3, cur, cur)
        ups[level] = lev
    params["up"] = ups
    params["norm_out"] = _norm_init(cur, dev)
    params["conv_out"] = _conv_init(g, 3, 3, cur, cfg.out_ch)
    return params


def latent_init(generator: torch.Generator, cfg: VQGANConfig, size):
    """The trainable z for an output of size (H, W): 0.1 * randn
    [1, z_channels, H/f, W/f], on the generator's device."""
    h, w = size
    return 0.1 * torch.randn((1, cfg.z_channels, h // cfg.f, w // cfg.f),
                             generator=generator, device=generator.device)


def decode_dtype(device) -> torch.dtype:
    """"auto": bf16 on the card unless APHANTASIA_DECODE_F32=1 (read at
    each decode, as the JAX package reads it at each trace), float32 on
    the CPU."""
    if (device.type == "cuda"
            and os.environ.get("APHANTASIA_DECODE_F32") != "1"):
        return torch.bfloat16
    return torch.float32


@dataclasses.dataclass(frozen=True)
class VQGANParameterizer:
    """A latent-z generator over a frozen decoder.  `compute_dtype`: the
    decoder's dtype, "auto" (`decode_dtype`) or a torch dtype; the
    decoder is cast once per dtype and kept."""
    size: tuple
    cfg: VQGANConfig
    decoder_params: dict = dataclasses.field(default=None, repr=False,
                                             compare=False)
    compute_dtype: object = "auto"
    _cast: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def init(self, generator: torch.Generator) -> torch.Tensor:
        return latent_init(generator, self.cfg, self.size)

    def decoder(self, dtype) -> dict:
        """The decoder cast to `dtype`, made once."""
        if dtype not in self._cast:
            self._cast[dtype] = cast_decoder(self.decoder_params, dtype)
        return self._cast[dtype]

    def decode(self, z, shift=None, contrast: float = 1.0) -> torch.Tensor:
        del shift, contrast
        dt = self.compute_dtype
        if dt == "auto":
            dt = decode_dtype(z.device)
        return vqgan_decode(self.decoder(dt), self.cfg, z)

    def image(self, z, shift=None, contrast: float = 1.0) -> torch.Tensor:
        return self.decode(z)


# ---------------------------------------------------------------- checkpoints

class _Stub:
    """What the restricted read stands in for a class outside torch: it
    takes any arguments and state and runs nothing."""

    def __init__(self, *args, **kw):
        pass

    def __setstate__(self, state):
        pass


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        if module == "torch" or module.startswith("torch."):
            obj = super().find_class(module, name)
            if (name.startswith("_rebuild") or name.endswith("Storage")
                    or isinstance(obj, torch.dtype)
                    or obj in (torch.Size, torch.device)):
                return obj
        return _Stub


class _restricted_pickle:
    """A `pickle_module` for torch.load: its Unpickler builds tensors and
    containers and a `_Stub` for every other class."""
    Unpickler = _RestrictedUnpickler
    load = pickle.load
    __name__ = "restricted_pickle"


def load_checkpoint(path: str) -> dict:
    """A taming checkpoint's state dict.  `torch.load(weights_only=True)`
    first.  A Lightning `.ckpt` also pickles its trainer's callbacks,
    whose classes (pytorch_lightning's) that refuses: such a file is read
    again by a restricted unpickler, which builds tensors and containers
    from torch, collections and numpy and puts an inert stub in place of
    every other class, so no code of the checkpoint runs.  Only its
    `state_dict` (or the file itself, when it is the state dict) is used."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        sd = torch.load(path, map_location="cpu", weights_only=False,
                        pickle_module=_restricted_pickle)
    return sd.get("state_dict", sd)


def convert_taming(path_or_sd, cfg: VQGANConfig, device="cpu"):
    """A taming-transformers checkpoint (a path, or a state dict with
    'decoder.*' and 'post_quant_conv.*' keys, OIHW tensors or arrays) ->
    the decoder tree, float32, on `device`: `cfg`'s levels, each with the
    blocks, attentions and upsample conv the keys hold."""
    sd = load_checkpoint(path_or_sd) if isinstance(path_or_sd, str) \
        else path_or_sd

    def arr(key):
        v = sd[key]
        v = v.detach().cpu().float() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v, np.float32))
        return v.contiguous().to(device)

    def conv(prefix):
        return {"w": arr(prefix + ".weight"), "b": arr(prefix + ".bias")}

    def norm(prefix):
        return {"g": arr(prefix + ".weight"), "b": arr(prefix + ".bias")}

    def res(prefix):
        p = {"norm1": norm(prefix + ".norm1"),
             "conv1": conv(prefix + ".conv1"),
             "norm2": norm(prefix + ".norm2"),
             "conv2": conv(prefix + ".conv2")}
        if prefix + ".nin_shortcut.weight" in sd:
            p["nin"] = conv(prefix + ".nin_shortcut")
        return p

    def attn(prefix):
        return {"norm": norm(prefix + ".norm"), "q": conv(prefix + ".q"),
                "k": conv(prefix + ".k"), "v": conv(prefix + ".v"),
                "proj": conv(prefix + ".proj_out")}

    ups = []
    for level in range(len(cfg.ch_mult)):
        lev = {"blocks": []}
        j = 0
        while f"decoder.up.{level}.block.{j}.norm1.weight" in sd:
            lev["blocks"].append(res(f"decoder.up.{level}.block.{j}"))
            j += 1
        attns = []
        j = 0
        while f"decoder.up.{level}.attn.{j}.norm.weight" in sd:
            attns.append(attn(f"decoder.up.{level}.attn.{j}"))
            j += 1
        if attns:
            lev["attns"] = attns
        if f"decoder.up.{level}.upsample.conv.weight" in sd:
            lev["upsample"] = conv(f"decoder.up.{level}.upsample.conv")
        ups.append(lev)

    out = {
        "conv_in": conv("decoder.conv_in"),
        "mid": {"block1": res("decoder.mid.block_1"),
                "attn": attn("decoder.mid.attn_1"),
                "block2": res("decoder.mid.block_2")},
        "up": ups,
        "norm_out": norm("decoder.norm_out"),
        "conv_out": conv("decoder.conv_out"),
    }
    if "post_quant_conv.weight" in sd:
        out["post_quant"] = conv("post_quant_conv")
    return out
