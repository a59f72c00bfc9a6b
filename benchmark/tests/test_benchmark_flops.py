"""The operation and byte counts against hand counts."""
from __future__ import annotations

import os

import pytest

from benchmark.harness import core, flops, timing


def _config(name):
    return core.load_json(os.path.join(core.BENCH_DIR, "configs", name))


def test_vit_b32_forward_is_8_82_gflop():
    cfg = _config("clip-vitb32.json")
    # patchify 49 patches of 3*32*32 into 768; 12 layers of 50 tokens:
    # 24 t d^2 + 4 t^2 d; the projection 768 -> 512
    hand = (2 * 49 * 3072 * 768 + 12 * (24 * 50 * 768 ** 2 + 4 * 50 ** 2 * 768)
            + 2 * 768 * 512)
    assert hand == 8_817_623_040
    assert flops.vit_forward_ops(cfg["vision"], cfg["embed_dim"]) == hand
    # the step: forward and input gradient, twice the forward, a cutout
    assert flops.tower_step_ops(cfg, 190) == pytest.approx(
        190 * 2 * 8.8176e9, rel=1e-4)


def test_vit_b32_weight_count_is_the_released_tower():
    cfg = _config("clip-vitb32.json")
    # ViT-B/32's visual tower holds 87,849,216 parameters
    assert flops.vit_weight_count(cfg["vision"], cfg["embed_dim"]) \
        == 87_849_216


def test_vqgan_counts_by_hand_on_a_small_decoder():
    dec = {"z_channels": 4, "ch": 8, "ch_mult": [1, 2], "num_res_blocks": 0,
           "out_ch": 3}
    h, w = 8, 8                     # latent 4 x 4 (f = 2), n = 16
    n, big = 16, 64

    def cv(cin, cout, k, px):
        return 2 * k * k * cin * cout * px
    # conv_in 4->16, mid: two res blocks 16->16 and one attention (four
    # 1x1 convs and two products), level 1 (16 channels): one res block
    # and one attention, upsample conv at 8 x 8, level 0: res 16->8 with
    # its 1x1 shortcut, conv_out 8->3
    conv = (cv(4, 16, 3, n) + 2 * 2 * cv(16, 16, 3, n) + 4 * cv(16, 16, 1, n)
            + 2 * cv(16, 16, 3, n) + 4 * cv(16, 16, 1, n)
            + cv(16, 16, 3, big)
            + cv(16, 8, 3, big) + cv(8, 8, 3, big) + cv(16, 8, 1, big)
            + cv(8, 3, 3, big))
    attn = 2 * 4 * n * n * 16
    assert flops.vqgan_ops(dec, h, w) == (conv, attn)
    assert flops.vqgan_step_ops(dec, h, w) == 3 * conv + 4 * attn


def test_vqgan_f16_at_480p_matches_the_smoke_bound():
    """The f16 decoder at 640x480: 1.19 TFLOP a forward, and its bf16
    forward and latent gradient bound at 2.4263 ms (chip_smoke's
    `check_vqgan_decode` gave the same bound)."""
    dec = _config("vqgan-f16-vitb32.json")["vqgan"]
    conv, attn = flops.vqgan_ops(dec, 480, 640)
    assert (conv + attn) / 1e12 == pytest.approx(1.194, abs=0.005)
    ms = timing.bound_ms(flops.vqgan_grad_bytes(dec, 480, 640),
                         2 * conv + 3 * attn, "bf16")
    assert ms == pytest.approx(2.4263, rel=2e-3)


def test_cut_bytes_by_hand():
    # 720 x 1280 float32 image and 190 cutouts of 224^2, each way
    hand = 2 * (3 * 720 * 1280 * 4 + 190 * 3 * 224 * 224 * 4)
    assert flops.cut_bytes(720, 1280, 190, 224) == hand
    assert timing.bound_ms(hand, 0, "bf16") == pytest.approx(
        hand / 3.35e12 * 1e3)


def test_bound_takes_the_larger_side():
    assert timing.bound_ms(3.35e9, 0, "bf16") == pytest.approx(1.0)
    assert timing.bound_ms(0, 989e9, "bf16") == pytest.approx(1.0)
    assert timing.bound_ms(3.35e9, 989e10, "bf16") == pytest.approx(10.0)
    assert timing.bound_ms(0, 67e9, "f32") == pytest.approx(1.0)
