"""Tiny cells for the CPU tests: a cell of the manifest with its
configuration cut to a few narrow layers and its traffic to a small
frame and a few cutouts, and the program's model tables patched to the
same shapes, so that a whole run (set-up, window, comparison) takes
seconds on the CPU."""
from __future__ import annotations

import contextlib
import copy
import time

from benchmark.harness import core

TINY_VISION = {"image_resolution": 64, "patch_size": 32, "width": 64,
               "layers": 2, "heads": 2}
TINY_TEXT = {"context_length": 77, "vocab_size": 49408, "width": 32,
             "layers": 2, "heads": 2}
TINY_VQGAN = {"name": "imagenet_f16_16384", "z_channels": 8, "ch": 16,
              "ch_mult": [1, 2], "num_res_blocks": 1, "out_ch": 3,
              "attn_resolutions": [16]}


def _set_flag(flags, name, value):
    flags = list(flags)
    flags[flags.index(name) + 1] = value
    return flags


def tiny_cell(workload: str, size=(64, 96), samples: int = 8) -> core.Cell:
    """The manifest's cell at a tiny size (h, w)."""
    cell = core.Cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg.update(embed_dim=32, vision=dict(TINY_VISION), text=dict(TINY_TEXT))
    if "vqgan" in cfg:
        cfg["vqgan"] = dict(TINY_VQGAN)
    cell.config = cfg
    tr = copy.deepcopy(cell.traffic)
    tr["flags"] = _set_flag(tr["flags"], "--size", f"{size[1]}-{size[0]}")
    tr["flags"] = _set_flag(tr["flags"], "--samples", str(samples))
    s = tr["settings"]
    s["size"] = list(size)
    over = s["padded"] != list(cell.traffic["settings"]["size"])
    s["padded"] = ([int(1.5 * size[0]), int(1.5 * size[1])] if over
                   else list(size))
    s["cutouts"] = int(samples * 0.95)
    s["modsize"] = TINY_VISION["image_resolution"]
    cell.traffic = tr
    return cell


@contextlib.contextmanager
def tiny_program():
    """The program's ViT-B/32 and f16 VQGAN entries at the tiny shapes."""
    from aphantasia_torch.models import vqgan
    from aphantasia_torch.models.clip import model
    old_clip = model.CLIP_CONFIGS["ViT-B/32"]
    old_vq = vqgan.VQGAN_CONFIGS["imagenet_f16_16384"]
    model.CLIP_CONFIGS["ViT-B/32"] = model.CLIPConfig(
        "ViT-B/32", 32, TINY_VISION["image_resolution"],
        TINY_VISION["layers"], TINY_VISION["width"],
        TINY_VISION["patch_size"], transformer_width=TINY_TEXT["width"],
        transformer_heads=TINY_TEXT["heads"],
        transformer_layers=TINY_TEXT["layers"],
        vision_heads_override=TINY_VISION["heads"])
    vqgan.VQGAN_CONFIGS["imagenet_f16_16384"] = vqgan.VQGANConfig(
        "imagenet_f16_16384", z_channels=TINY_VQGAN["z_channels"],
        ch=TINY_VQGAN["ch"], ch_mult=tuple(TINY_VQGAN["ch_mult"]),
        num_res_blocks=TINY_VQGAN["num_res_blocks"], attn_resolutions=(16,))
    try:
        yield
    finally:
        model.CLIP_CONFIGS["ViT-B/32"] = old_clip
        vqgan.VQGAN_CONFIGS["imagenet_f16_16384"] = old_vq


def run_tiny(cell, seed: int = 3, seconds: float = 0.0):
    """(result, compared, notes) of a whole run on the CPU."""
    from benchmark.run import execute
    with tiny_program():
        return execute(cell, seed, seconds, False, "cpu", time.time())
