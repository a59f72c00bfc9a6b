"""The plain reference against the port at a tiny size on the CPU: each
piece on the same inputs, then whole runs of each cell."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import check, weights
from benchmark.reference import clip as RC
from benchmark.reference import image as RI
from benchmark.reference import vqgan as RV
from benchmark.tests.tiny import (TINY_TEXT, TINY_VISION, TINY_VQGAN,
                                  run_tiny, tiny_cell, tiny_program)

CELLS = ("clip_fft.b32.720p", "clip_vqgan.f16.480p", "illustrip.b32.rgb.720p",
         "clip_fft.b32.4k")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    cfg = {"embed_dim": 32, "vision": TINY_VISION, "text": TINY_TEXT,
           "vqgan": TINY_VQGAN}
    d = tmp_path_factory.mktemp("weights")
    return cfg, weights.write_weights(cfg, 11, str(d), "cpu")


def test_towers_match_the_port(files):
    from aphantasia_torch.cli.common import ClipWrapper
    from aphantasia_torch.models.clip.model import encode_image
    cfg, paths = files
    with tiny_program():
        w = ClipWrapper("ViT-B/32", torch.device("cpu"), paths["clip"])
        x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(1))
        got = encode_image(w.params, w.cfg, x)
        embs, _ = w.enc_text("a small red boat")
    sd = RC.load_state_dict(paths["clip"], "cpu")
    ref = RC.encode_image(sd, cfg["vision"], x)
    assert torch.allclose(got, ref, atol=2e-5, rtol=1e-4)
    rembs, rw = RC.prompt_embeddings(sd, cfg["text"], "a small red boat")
    assert torch.allclose(embs, rembs, atol=2e-5, rtol=1e-4)
    assert rw.tolist() == [1.0]


def test_vqgan_decoder_matches_the_port(files):
    from aphantasia_torch.models import vqgan
    cfg, paths = files
    with tiny_program():
        vcfg = vqgan.VQGAN_CONFIGS["imagenet_f16_16384"]
        par = vqgan.VQGANParameterizer(
            (32, 48), vcfg, vqgan.convert_taming(paths["vqgan"], vcfg),
            torch.float32)
        z = 0.1 * torch.randn((1, 8, 16, 24),
                              generator=torch.Generator().manual_seed(2))
        got = par.image(z)
    ref = RV.decode(RC.load_state_dict(paths["vqgan"], "cpu"), cfg["vqgan"],
                    z)
    assert torch.allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("align", ["uniform", "overscan"])
def test_image_pieces_match_the_port(align):
    from aphantasia_torch.ops.augs import transforms_fast_affine
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.ops.warp import frame_transform
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.params.pixel import PixelParameterizer
    from aphantasia_torch.step import StepSettings, build_draw_fn
    h, w = 64, 96
    g = torch.Generator().manual_seed(4)
    par = FFTParameterizer((h, w), 1.5, 1.8)
    spec = par.init(g)
    img = par.image(spec, contrast=1.1)
    assert torch.equal(img, RI.fft_image(spec, (h, w), 1.5, 1.8, 1.1))
    pix = torch.randn((1, 3, h, w), generator=g)
    assert torch.equal(PixelParameterizer((h, w), 2.3).image(pix),
                       RI.pixel_image(pix, 2.3))
    s = CutoutSampler((h, w), 7, 64, align, 0.3)
    d = build_draw_fn(s, StepSettings(), None)(g)
    cuts = s.cut(img, d.cuts.boxes)
    dr = check.still_draws(check.plain(d))
    assert torch.equal(cuts, RI.cut(img, dr[0], (h, w), s.padded_size, 64))
    got = transforms_fast_affine(d.cuts.aug, cuts, compute_dtype=torch.float32)
    assert torch.allclose(got, RI.augment_fast(dr[1], cuts), atol=2e-4)
    motion = (0.7, (3.5, -2.25), 1.01, 0.3)
    got = frame_transform(pix, (h, w), motion[0], motion[1], motion[2],
                          motion[3])
    assert torch.allclose(got, RI.frame_motion(pix, *motion), atol=1e-4)
    assert torch.equal(RI.render(img), (torch.clamp(
        img[0].permute(1, 2, 0), 0, 1) * 255 + 0.5).to(torch.uint8))


@pytest.mark.parametrize("workload", CELLS)
def test_whole_tiny_run_is_correct(workload):
    """A whole run of the cell on the CPU at a tiny size: the program
    (its `fast` warp in bf16 there too) within the cell's limits."""
    result, compared, notes = run_tiny(tiny_cell(workload))
    assert result["correct"], compared
    assert compared["start_gap"]["value"] == 0.0
    assert compared["draws_bad"]["value"] == 0
    assert compared["loss0_gap"]["value"] < 5e-3
    assert compared["frame_gap"]["value"] <= 1
