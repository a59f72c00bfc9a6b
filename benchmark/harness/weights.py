"""Random weights from the run's seed, made on the device in a few large
calls and written in the layouts users load: an OpenAI CLIP state dict
and a taming-transformers VQGAN state dict, float16 as OpenAI's and the
usual taming releases store them.  The program loads them through its
checkpoint flags, and the reference reads the same files itself.

The scales follow OpenAI's initialisation (width^-1/2 for the attention
and projections, (2 width)^-1/2 for the MLP's input, 0.02 and 0.01 for the
text embeddings) and He-normal convolutions for the decoder; biases are
0 and norms the identity."""
from __future__ import annotations

import os

SALT_CLIP, SALT_VQGAN = 101, 202


def _fill(specs, seed: int, device):
    """{key: tensor} from [(key, shape, std)]: one normal draw on the
    device for all of them, cut and scaled; std 0 gives zeros, std None
    ones.  float16 on the host."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [_numel(s) if std else 0 for _, s, std in specs]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, shape, std), n in zip(specs, sizes):
        if std is None:
            t = torch.ones(shape, device=device)
        elif std == 0:
            t = torch.zeros(shape, device=device)
        else:
            t = draw[at:at + n].view(shape) * std
            at += n
        out[key] = t.half().cpu()
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _block_specs(prefix: str, d: int) -> list:
    return [(f"{prefix}.ln_1.weight", (d,), None),
            (f"{prefix}.ln_1.bias", (d,), 0),
            (f"{prefix}.attn.in_proj_weight", (3 * d, d), d ** -0.5),
            (f"{prefix}.attn.in_proj_bias", (3 * d,), 0),
            (f"{prefix}.attn.out_proj.weight", (d, d), d ** -0.5),
            (f"{prefix}.attn.out_proj.bias", (d,), 0),
            (f"{prefix}.ln_2.weight", (d,), None),
            (f"{prefix}.ln_2.bias", (d,), 0),
            (f"{prefix}.mlp.c_fc.weight", (4 * d, d), (2 * d) ** -0.5),
            (f"{prefix}.mlp.c_fc.bias", (4 * d,), 0),
            (f"{prefix}.mlp.c_proj.weight", (d, 4 * d), d ** -0.5),
            (f"{prefix}.mlp.c_proj.bias", (d,), 0)]


def clip_specs(config: dict) -> list:
    """The OpenAI ViT checkpoint's keys, shapes and scales."""
    v, t, e = config["vision"], config["text"], config["embed_dim"]
    d, p = v["width"], v["patch_size"]
    g = v["image_resolution"] // p
    specs = [("visual.conv1.weight", (d, 3, p, p), d ** -0.5),
             ("visual.class_embedding", (d,), d ** -0.5),
             ("visual.positional_embedding", (g * g + 1, d), d ** -0.5),
             ("visual.ln_pre.weight", (d,), None),
             ("visual.ln_pre.bias", (d,), 0)]
    for i in range(v["layers"]):
        specs += _block_specs(f"visual.transformer.resblocks.{i}", d)
    specs += [("visual.ln_post.weight", (d,), None),
              ("visual.ln_post.bias", (d,), 0),
              ("visual.proj", (d, e), d ** -0.5)]
    tw = t["width"]
    specs += [("token_embedding.weight", (t["vocab_size"], tw), 0.02),
              ("positional_embedding", (t["context_length"], tw), 0.01)]
    for i in range(t["layers"]):
        specs += _block_specs(f"transformer.resblocks.{i}", tw)
    specs += [("ln_final.weight", (tw,), None), ("ln_final.bias", (tw,), 0),
              ("text_projection", (tw, e), tw ** -0.5)]
    return specs


def taming_specs(dec: dict) -> list:
    """The taming decoder's keys (with `post_quant_conv`), shapes and
    scales."""
    specs = []

    def conv(prefix, cin, cout, k):
        specs.append((prefix + ".weight", (cout, cin, k, k),
                      (2.0 / (k * k * cin)) ** 0.5))
        specs.append((prefix + ".bias", (cout,), 0))

    def norm(prefix, c):
        specs.append((prefix + ".weight", (c,), None))
        specs.append((prefix + ".bias", (c,), 0))

    def res(prefix, cin, cout):
        norm(prefix + ".norm1", cin)
        conv(prefix + ".conv1", cin, cout, 3)
        norm(prefix + ".norm2", cout)
        conv(prefix + ".conv2", cout, cout, 3)
        if cin != cout:
            conv(prefix + ".nin_shortcut", cin, cout, 1)

    def attn(prefix, c):
        norm(prefix + ".norm", c)
        for n in ("q", "k", "v", "proj_out"):
            conv(f"{prefix}.{n}", c, c, 1)

    ch, mult, z = dec["ch"], dec["ch_mult"], dec["z_channels"]
    cur = ch * mult[-1]
    conv("post_quant_conv", z, z, 1)
    conv("decoder.conv_in", z, cur, 3)
    res("decoder.mid.block_1", cur, cur)
    attn("decoder.mid.attn_1", cur)
    res("decoder.mid.block_2", cur, cur)
    for level in reversed(range(len(mult))):
        cout = ch * mult[level]
        for j in range(dec["num_res_blocks"] + 1):
            res(f"decoder.up.{level}.block.{j}", cur, cout)
            cur = cout
            if level == len(mult) - 1:
                attn(f"decoder.up.{level}.attn.{j}", cur)
        if level:
            conv(f"decoder.up.{level}.upsample.conv", cur, cur, 3)
    norm("decoder.norm_out", cur)
    conv("decoder.conv_out", cur, dec["out_ch"], 3)
    return specs


def write_weights(config: dict, seed: int, directory: str, device) -> dict:
    """Write the configuration's checkpoints into `directory`:
    {"clip": path[, "vqgan": path]}."""
    import torch
    paths = {}
    sd = _fill(clip_specs(config), seed + SALT_CLIP, device)
    sd["logit_scale"] = torch.tensor(4.6052, dtype=torch.float16)
    paths["clip"] = os.path.join(directory, "clip_openai.pt")
    torch.save(sd, paths["clip"])
    if "vqgan" in config:
        sd = _fill(taming_specs(config["vqgan"]), seed + SALT_VQGAN, device)
        paths["vqgan"] = os.path.join(directory, "vqgan_taming.pt")
        torch.save(sd, paths["vqgan"])
    del sd
    return paths
