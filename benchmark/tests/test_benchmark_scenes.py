"""The scene cell `illustra.l14-336.38cut` on the CPU at a tiny size: a
whole run through the `scenes` driver is correct, the control and the
half-batch faults are not, its traffic's settings are what `illustra`
resolves from its flags, and `attn_roofline`'s operation count on a
hand-worked case.  The program's ViT-L/14@336px entry is patched to a
tiny geometry of 17 tokens (t != 50, so the vision blocks run unfused and
through the flat attention core, as the cell's 577 tokens do)."""
from __future__ import annotations

import contextlib
import copy
import os
import time

import pytest

from benchmark.harness import check, core
from benchmark.tests.tiny import TINY_TEXT, _set_flag

CELL = "illustra.l14-336.38cut"
MODEL = "ViT-L/14@336px"
TINY_L14 = {"image_resolution": 56, "patch_size": 14, "width": 64,
            "layers": 2, "heads": 2}


def tiny_scene_cell(size=(64, 96), samples: int = 8,
                    steps: int = 20) -> core.Cell:
    """The cell at a tiny size (h, w): 7 cutouts of 56 px, scenes of 20
    steps, 10 a dispatch."""
    cell = core.Cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(embed_dim=32, vision=dict(TINY_L14), text=dict(TINY_TEXT))
    cell.config = cfg
    tr = copy.deepcopy(cell.traffic)
    for flag, value in (("--size", f"{size[1]}-{size[0]}"),
                        ("--samples", str(samples)), ("--steps", str(steps))):
        tr["flags"] = _set_flag(tr["flags"], flag, value)
    s = tr["settings"]
    s.update(size=list(size), padded=list(size),
             cutouts=int(samples * 0.95), modsize=TINY_L14["image_resolution"])
    cell.traffic = tr
    return cell


@contextlib.contextmanager
def tiny_program():
    """The program's ViT-L/14@336px entry at the tiny shapes."""
    from aphantasia_torch.models.clip import model
    old = model.CLIP_CONFIGS[MODEL]
    model.CLIP_CONFIGS[MODEL] = model.CLIPConfig(
        MODEL, 32, TINY_L14["image_resolution"], TINY_L14["layers"],
        TINY_L14["width"], TINY_L14["patch_size"],
        transformer_width=TINY_TEXT["width"],
        transformer_heads=TINY_TEXT["heads"],
        transformer_layers=TINY_TEXT["layers"],
        vision_heads_override=TINY_L14["heads"])
    try:
        yield
    finally:
        model.CLIP_CONFIGS[MODEL] = old


def test_tiny_geometry_runs_unfused():
    import torch
    from aphantasia_torch.models.clip import model
    g = TINY_L14["image_resolution"] // TINY_L14["patch_size"]
    assert g * g + 1 == 17
    with tiny_program():
        assert model.input_resolution(MODEL) == 56
    x = torch.zeros((7 * 17, TINY_L14["width"]), dtype=torch.bfloat16)
    assert model.fused_blocks(x, [], 17) is False


def test_a_tiny_run_is_correct_and_stays_in_scene_0():
    """A whole run (set-up, window, comparison) through the driver: every
    limit met, and a window asked for far longer than the scene ends at
    scene 0's last dispatch."""
    from benchmark.run import execute
    cell = tiny_scene_cell()
    with tiny_program():
        result, compared, notes = execute(cell, 2 ** 31 + 12345, 1e9, False,
                                          "cpu", time.time())
    assert result["correct"] is True, compared
    assert compared["start_gap"]["value"] == 0
    assert result["attempted"] == 10    # the scene's second and last dispatch
    assert notes["end_to_end"]["steps_per_s"] > 0


def test_control_and_half_faults_are_not_correct():
    from benchmark.control import readings
    cell = tiny_scene_cell()
    with tiny_program():
        r = readings(cell, 7, True, "cpu")
    prog = check.judge(r["program"], cell.limits)
    assert all(v["ok"] for v in prog.values()), prog
    for side in ("control", "half_cuts", "half_loss"):
        got = check.judge(r[side], cell.limits)
        assert not all(v["ok"] for v in got.values()), (side, got)


def test_traffic_settings_are_what_illustra_resolves():
    """38 cutouts after illustra's own budget (`sample_budget`), 336 px
    cutouts, the FFT defaults, 15 steps a dispatch and a frame a step."""
    from aphantasia_torch.cli import illustra
    from aphantasia_torch.models.clip.model import input_resolution
    from aphantasia_torch.ops.losses import aesthetic_dims
    from aphantasia_torch.step import frames_per_dispatch
    cell = core.Cell(CELL)
    tr, s = cell.traffic, cell.traffic["settings"]
    a = illustra.get_args(list(tr["flags"]) + ["-t", "x", "--device", "cpu"])
    assert a.model == MODEL == cell.config["model"]
    assert illustra.sample_budget(a.samples, a.model, a.dualmod,
                                  a.transform, a.enforce) == s["cutouts"] == 38
    assert input_resolution(a.model) == s["modsize"] == 336
    assert list(a.size) == s["size"] == s["padded"]
    assert (a.lrate, a.decay, a.colors, a.contrast) == (
        s["lr"], s["decay"], s["colors"], s["contrast"])
    assert a.sim == s["sim"] and a.transform == "fast"
    assert a.align == "uniform" and a.noise == 0
    assert aesthetic_dims(a.model) is None       # no aesthetic term
    assert a.save_step == 1
    assert frames_per_dispatch(tuple(a.size), a.steps // a.save_step) == 15
    assert len(tr["scenes"]) == 4


def test_attn_roofline_counts_12_t2_d_a_layer_and_cutout(monkeypatch):
    """t = (28 / 14)^2 + 1 = 5 tokens of width 8, 3 layers, 2 cutouts:
    12 * 25 * 8 * 3 * 2 = 14400 operations; 14400 over 1 ms at 989
    TFLOP/s is 1.456e-6 percent."""
    reader = core.Cell(CELL).reader("attn_roofline.still")
    vision = {"image_resolution": 28, "patch_size": 14, "width": 8,
              "layers": 3}
    assert reader.attn_step_ops(vision, 2) == 14400.0
    monkeypatch.setattr(reader.spans, "layer_ms", lambda lay: {"attn": 1.0})
    got = reader.read({"config": {"vision": vision}, "cutouts": 2})
    assert got == pytest.approx(1.456e-6, rel=1e-3)
    at_full = {"image_resolution": 336, "patch_size": 14, "width": 1024,
               "layers": 24}
    assert reader.attn_step_ops(at_full, 38) == 12 * 577 ** 2 * 1024 * 24 * 38


def test_attn_readers_find_nothing_without_marks():
    cell = core.Cell(CELL)
    for name in ("attn_ms.still", "attn_roofline.still"):
        assert cell.reader(name).read({"graphs": []}) is None


def test_the_cell_reads_the_still_metrics_and_its_own():
    cell = core.Cell(CELL)
    names = {m["name"] for m in cell.per_layer()}
    assert {"attn_ms.still", "attn_roofline.still", "tower_ms.still",
            "kernels_per_step.still", "setup_clip_s"} <= names
    assert "vqgan_decode_roofline" not in names
    assert os.path.basename(cell.driver_path) == "scenes.py"
