"""The port's clip_fft CLI on the CPU (`--device cpu`) at a tiny size, its
outputs, the flags it does not port yet, and the package's isolation from
JAX and from aphantasia_tpu."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from aphantasia_torch.cli import clip_fft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "aphantasia_torch")
TINY = ["--size", "96-64", "--samples", "4", "--steps", "2", "-nv",
        "--device", "cpu"]


def _run(argv):
    return clip_fft.run(clip_fft.get_args(argv))


@pytest.mark.parametrize("pallas", [False, True])
def test_clip_fft_cpu_outputs(tmp_path, pallas):
    out = str(tmp_path / "out")
    res = _run(["-t", "a test prompt", "--out_dir", out, "--save_pt"] + TINY
               + (["--pallas"] if pallas else []))
    run_dir = os.path.join(out, res.out_name)
    frames = sorted(f for f in os.listdir(run_dir) if f.endswith(".jpg"))
    assert frames == ["0000.jpg", "0001.jpg"]
    from PIL import Image
    with Image.open(os.path.join(run_dir, frames[0])) as im:
        assert im.size == (96, 64)
    cfg = open(os.path.join(run_dir, "config.txt")).read()
    assert "in_txt: a test prompt" in cfg and "samples: 3" in cfg
    assert res.video is not None and os.path.getsize(res.video) > 0
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    # the snapshot is a params list, readable by the JAX package's codec
    from aphantasia_tpu.io.checkpoint import load_pt
    obj = load_pt(os.path.join(out, res.out_name + ".pt"))
    assert isinstance(obj, list) and obj[0].shape == (1, 3, 64, 49, 2)
    np.testing.assert_array_equal(obj[0], res.params.numpy())


def test_clip_fft_vit_b16_with_image_prompt(tmp_path):
    """ViT-B/16 (t=197 on the flat stream) and an image prompt encoded
    through the cutout sampler."""
    from aphantasia_torch.io.media import img_save
    src = str(tmp_path / "src.PNG")
    img_save(src, np.random.RandomState(0).rand(64, 96, 3))
    res = _run(["-t", "abc", "-i", src, "-m", "ViT-B/16", "--out_dir",
                str(tmp_path / "o")] + TINY)
    assert res.samples == 1 and res.out_name == "abc-src-ViTB16"
    assert all(np.isfinite(res.losses))


def test_clip_fft_resume_from_pt(tmp_path):
    out = str(tmp_path / "a")
    res = _run(["-t", "abc", "--out_dir", out, "--save_pt"] + TINY)
    pt = os.path.join(out, res.out_name + ".pt")
    res2 = _run(["-t", "abc", "--out_dir", str(tmp_path / "b"), "-r", pt]
                + TINY)
    assert all(np.isfinite(res2.losses))


@pytest.mark.parametrize("flags", [
    ["--dwt"], ["--sync", "0.5"], ["--aest", "1"], ["--dualmod", "2"],
    ["--spatial", "2"], ["--mesh", "2"], ["--fleet", "0/2"],
    ["--profile", "p"], ["--persp", "exact"], ["-tf", "custom"],
    ["-tf", "elastic"], ["-m", "RN50"]])
def test_unported_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(["-t", "x", "--out_dir", str(tmp_path)] + TINY + flags)


def test_cuda_entry_point_raises_without_gpu(monkeypatch, tmp_path):
    from aphantasia_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(["-t", "x", "--out_dir", str(tmp_path), "--steps", "1", "-nv"])
    assert resolve_device("cpu").type == "cpu"


def test_frame_writer_normalises_floats_and_extensions(tmp_path):
    from PIL import Image
    from aphantasia_torch.io.media import AsyncFrameWriter
    frame = np.linspace(-0.5, 1.5, 8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    with AsyncFrameWriter(encoders=2) as w:
        w.save(str(tmp_path / "a.JPG"), frame)
        w.save(str(tmp_path / "b.png"), frame)
    with Image.open(tmp_path / "b.png") as im:
        got = np.asarray(im)
    np.testing.assert_array_equal(got, (np.clip(frame, 0, 1) * 255)
                                  .astype(np.uint8))
    with Image.open(tmp_path / "a.JPG") as im:
        assert im.format == "JPEG" and im.size == (6, 8)


def test_package_imports_neither_jax_nor_the_jax_package():
    mods = []
    for dp, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dp, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").replace(".__init__", ""))
                src = open(os.path.join(dp, f)).read()
                assert not re.search(r"^\s*(import|from)\s+(jax|optax|"
                                     r"aphantasia_tpu)\b", src, re.M), f
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'aphantasia_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
