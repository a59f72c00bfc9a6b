"""The port's clip_fft CLI on the CPU (`--device cpu`) at a tiny size, its
outputs, every augmentation option, --dwt, --sync, --aest, --dualmod,
--clip_weights, --mesh and --fleet, the flag it does not port yet, and
the package's isolation from JAX and from aphantasia_tpu."""
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
    ["--spatial", "2"], ["--mesh", "2"], ["--fleet", "0/2"],
    ["-m", "RN50x64"]])
def test_unported_flags_raise(tmp_path, monkeypatch, flags):
    """RN50x64, which JAX clip_fft does not offer (illustra does), is
    refused by argparse, as in JAX.  --spatial, --mesh and --fleet, which
    raised until they were ported, pass the CLI's launch
    (`common.run_cli`): --spatial 2 and --mesh 2 each plan two gloo ranks
    on this host (the runs themselves are held to JAX and to the dense run
    in tests/test_torch_spatial.py and
    tests/test_torch_dcn.py::test_clip_fft_mesh_matches_dense); --fleet
    0/2 without a coordinator runs the whole job once, in this process,
    with the fleet's coordinates."""
    from aphantasia_torch.cli.common import mesh_plan, run_cli
    from aphantasia_torch.parallel import multihost
    if flags[0] == "-m":
        with pytest.raises(SystemExit):
            _run(["-t", "x", "--out_dir", str(tmp_path)] + TINY + flags)
        return
    a = clip_fft.get_args(["-t", "x", "--out_dir", str(tmp_path)] + TINY
                          + flags)
    if flags[0] in ("--mesh", "--spatial"):
        plan = mesh_plan(a.mesh, a.device, a.spatial)
        assert (plan.n_local, plan.world, plan.device) == (2, 2, "cpu")
        assert plan.addr.startswith("127.0.0.1:")
        return
    monkeypatch.setattr(multihost, "_FLEET", None)
    monkeypatch.setattr(multihost, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    calls = []
    assert run_cli(a, lambda b: calls.append(multihost.fleet_info())
                   or "done") == "done"
    assert calls == [(0, 2)]


# ViT-B/32's geometry (224 px, 32 px patches) cut to one block of width
# 64 in each tower: the converter reads the widths from the tensors
TINY_B32 = dict(name="ViT-B/32", embed_dim=32, image_resolution=224,
                vision_layers=1, vision_width=64, vision_patch_size=32,
                transformer_width=64, transformer_heads=1,
                transformer_layers=1)


def _tiny_checkpoint(path):
    """A TINY_B32 checkpoint in the OpenAI key layout: random weights
    from a seed, fp16 as OpenAI's releases store them."""
    from aphantasia_torch.models.clip import model as tm
    from aphantasia_torch.models.clip.convert import openai_state_dict
    params = tm.clip_init(torch.Generator().manual_seed(3),
                          tm.CLIPConfig(**TINY_B32))
    torch.save({k: v.half() for k, v in openai_state_dict(params).items()},
               path)
    return params


@pytest.mark.parametrize("flags,out_name", [
    (["--dwt", "--save_pt"], "x-ViTB32"),
    (["--sync", "0.5", "-i", "IMG"], "x-src-ViTB32"),
    (["--aest", "1"], "x-ViTB32"),
    (["--dualmod", "2"], "x-dm2"),
    (["--clip_weights", "CKPT"], "x-ViTB32")])
def test_ported_flags_run(tmp_path, monkeypatch, flags, out_name):
    """Each flag that raised until it was ported runs end to end: two
    frames, config.txt with the flag, finite losses and the JAX CLI's
    out-name.  --dwt saves the pyramid list; --sync with an --in_img file
    the test writes samples by overscan and tone-maps the frames;
    --clip_weights loads a checkpoint the test writes (TINY_B32: the
    tower the CLI runs is the checkpoint's)."""
    from aphantasia_torch.io.media import img_save
    from aphantasia_torch.models.clip import model as tm
    src, ckpt = str(tmp_path / "src.png"), str(tmp_path / "w.pt")
    img_save(src, np.random.RandomState(0).rand(64, 96, 3))
    flags = [{"IMG": src, "CKPT": ckpt}.get(f, f) for f in flags]
    if ckpt in flags:
        want = _tiny_checkpoint(ckpt)
        monkeypatch.setitem(tm.CLIP_CONFIGS, "ViT-B/32",
                            tm.CLIPConfig(**TINY_B32))
    out = str(tmp_path / "out")
    a = clip_fft.get_args(["-t", "x", "--out_dir", out] + TINY + flags)
    res = clip_fft.run(a)
    assert res.out_name == out_name
    run_dir = os.path.join(out, out_name)
    frames = sorted(f for f in os.listdir(run_dir) if f.endswith(".jpg"))
    assert frames == ["0000.jpg", "0001.jpg"]
    cfg = open(os.path.join(run_dir, "config.txt")).read()
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    if "--dwt" in flags:
        assert "dwt: True" in cfg and isinstance(res.params, list)
        from aphantasia_tpu.io.checkpoint import load_pt
        obj = load_pt(os.path.join(out, out_name + ".pt"))
        assert [o.shape for o in obj] == [tuple(p.shape) for p in res.params]
    if "--sync" in flags:
        assert "sync: 0.5" in cfg and a.align == "overscan"
    if "--aest" in flags:
        assert "aest: 1.0" in cfg
    if "--dualmod" in flags:
        assert "dualmod: 2" in cfg and "sim: cossim" in cfg
    if ckpt in flags:
        assert "clip_weights: " + ckpt in cfg
        loaded, _ = tm.load_clip("ViT-B/32", ckpt)
        np.testing.assert_array_equal(
            loaded["visual"]["conv"].numpy(),
            want["visual"]["conv"].half().float().numpy())


@pytest.mark.parametrize("flags", [
    ["--persp", "mixed"], ["--persp", "exact"], ["-tf", "custom"],
    ["-tf", "elastic"], ["-tf", "lucent"], ["-tf", "openai"]])
def test_clip_fft_cpu_augmentations(tmp_path, flags):
    """Each augmentation pipeline and perspective mode runs end to end."""
    out = str(tmp_path / "out")
    res = _run(["-t", "x", "--out_dir", out] + TINY + flags)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert torch.isfinite(res.params).all()
    frames = [f for f in os.listdir(os.path.join(out, res.out_name))
              if f.endswith(".jpg")]
    assert len(frames) == 2


def test_persp_flag_wins_over_the_environment(monkeypatch):
    """--persp wins; without it APHANTASIA_EXACT_PERSP=mixed selects
    mixed, any other non-empty value exact, unset or empty affine (the
    JAX CLIs' apply_persp)."""
    from aphantasia_torch.cli.common import resolve_persp
    monkeypatch.delenv("APHANTASIA_EXACT_PERSP", raising=False)
    assert resolve_persp(None) == "affine"
    assert resolve_persp("exact") == "exact"
    for env, want in (("mixed", "mixed"), ("1", "exact"), ("", "affine")):
        monkeypatch.setenv("APHANTASIA_EXACT_PERSP", env)
        assert resolve_persp(None) == want
        assert resolve_persp("affine") == "affine"


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
