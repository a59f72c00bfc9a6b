"""Operations and bytes of the work a step requires, from the shapes in a
configuration file (the benchmark's own arithmetic: it reads nothing of
the program).

ViT image tower (OpenAI CLIP, frozen): a forward over t = (r/p)^2 + 1
tokens is the patchify 2 (r/p)^2 3p^2 d, per layer 24 t d^2 (qkv 6, out
2, MLP 16 with ratio 4) plus 4 t^2 d (scores and values), and the
projection 2 d e.  The step needs the forward and the gradient of the
input only (the weights are frozen): one product again for each forward
product, so the step is twice the forward.  ViT-B/32: 8.82 GFLOP a
cutout forward.

VQGAN decoder (taming, frozen): 2 k^2 cin cout per output pixel of each
convolution and 2 t^2 c for each of an attention's two products; the
step is a forward and the latent's gradient (each convolution's data
gradient once more, each attention product twice more: 2 conv + 3 attn),
and the frame's render a forward again.
"""
from __future__ import annotations


def vit_forward_ops(vision: dict, embed_dim: int) -> float:
    """Operations of one cutout through the image tower's forward."""
    d, p = vision["width"], vision["patch_size"]
    g = vision["image_resolution"] // p
    t = g * g + 1
    patchify = 2 * g * g * 3 * p * p * d
    per_layer = 24 * t * d * d + 4 * t * t * d
    return float(patchify + vision["layers"] * per_layer + 2 * d * embed_dim)


def vit_weight_count(vision: dict, embed_dim: int) -> int:
    """The image tower's parameters (matmul weights, embeddings, norms)."""
    d, p = vision["width"], vision["patch_size"]
    g = vision["image_resolution"] // p
    per_layer = 12 * d * d + 13 * d
    return (3 * p * p * d + d + (g * g + 1) * d + 4 * d
            + vision["layers"] * per_layer + d * embed_dim)


def tower_step_ops(config: dict, cutouts: int) -> float:
    """The tower's forward and input gradient over a step's cutouts."""
    return 2.0 * vit_forward_ops(config["vision"], config["embed_dim"]) \
        * cutouts


def tower_step_bytes(config: dict, cutouts: int, itemsize: int = 2) -> float:
    """Bytes the tower's step must move at least: its weights read once
    each way, the cutouts read and their gradient written, the
    embeddings written and their gradient read."""
    v = config["vision"]
    r = v["image_resolution"]
    weights = vit_weight_count(v, config["embed_dim"]) * itemsize
    images = cutouts * 3 * r * r * itemsize
    embeds = cutouts * config["embed_dim"] * 4
    return float(2 * (weights + images + embeds))


def vqgan_ops(dec: dict, h: int, w: int) -> tuple:
    """(convolution, attention) operations of one decoder forward to an
    h x w image."""
    ch, mult = dec["ch"], dec["ch_mult"]
    f = 2 ** (len(mult) - 1)
    n = (h // f) * (w // f)
    conv = attn = 0

    def cv(cin, cout, k, n):
        return 2 * k * k * cin * cout * n

    def res(cin, cout, n):
        return (cv(cin, cout, 3, n) + cv(cout, cout, 3, n)
                + (cv(cin, cout, 1, n) if cin != cout else 0))

    cur = ch * mult[-1]
    conv += cv(dec["z_channels"], cur, 3, n) + 2 * res(cur, cur, n) \
        + 4 * cv(cur, cur, 1, n)
    attn += 4 * n * n * cur
    for level in reversed(range(len(mult))):
        cout = ch * mult[level]
        for _ in range(dec["num_res_blocks"] + 1):
            conv += res(cur, cout, n)
            cur = cout
            if level == len(mult) - 1:
                conv += 4 * cv(cur, cur, 1, n)
                attn += 4 * n * n * cur
        if level:
            n *= 4
            conv += cv(cur, cur, 3, n)
    conv += cv(cur, dec["out_ch"], 3, n)
    return float(conv), float(attn)


def vqgan_weight_count(dec: dict) -> int:
    """The decoder's parameters (convolutions with biases, norms)."""
    ch, mult, z = dec["ch"], dec["ch_mult"], dec["z_channels"]

    def conv(cin, cout, k):
        return k * k * cin * cout + cout

    def res(cin, cout):
        return (2 * cin + conv(cin, cout, 3) + 2 * cout + conv(cout, cout, 3)
                + (conv(cin, cout, 1) if cin != cout else 0))

    def attn(c):
        return 2 * c + 4 * conv(c, c, 1)

    cur = ch * mult[-1]
    total = conv(z, cur, 3) + 2 * res(cur, cur) + attn(cur)
    for level in reversed(range(len(mult))):
        cout = ch * mult[level]
        for _ in range(dec["num_res_blocks"] + 1):
            total += res(cur, cout)
            cur = cout
            if level == len(mult) - 1:
                total += attn(cur)
        if level:
            total += conv(cur, cur, 3)
    return total + 2 * cur + conv(cur, dec["out_ch"], 3)


def vqgan_step_ops(dec: dict, h: int, w: int) -> float:
    """A step's decoder work: forward and latent gradient (2 conv +
    3 attn), then the frame's render forward (conv + attn)."""
    conv, attn = vqgan_ops(dec, h, w)
    return 3 * conv + 4 * attn


def vqgan_grad_bytes(dec: dict, h: int, w: int, itemsize: int = 2) -> float:
    """Bytes of the decode's forward and latent gradient at least: the
    weights read each way, the latent read and its gradient written, the
    image written and its gradient read."""
    f = 2 ** (len(dec["ch_mult"]) - 1)
    latent = dec["z_channels"] * (h // f) * (w // f) * 4
    image = 3 * h * w * 4
    return float(2 * (vqgan_weight_count(dec) * itemsize + latent + image))


def cut_bytes(h: int, w: int, cutouts: int, modsize: int) -> float:
    """The cut's forward and backward at least: the float32 image read
    once and the float32 cutouts written once, then the cutouts'
    gradient read once and the image's written once."""
    return float(2 * (3 * h * w * 4 + cutouts * 3 * modsize * modsize * 4))


def cut_ops(cutouts: int, modsize: int) -> float:
    """A bicubic cutout's 16 taps a channel and pixel, each way."""
    return float(2 * 2 * 16 * cutouts * 3 * modsize * modsize)
