"""The port's fleets (aphantasia_torch/parallel/multihost.py and the fleet
paths of cli/illustra.py and cli/interpol.py) on the CPU: `parse_fleet`
and `shard_scenes` against the JAX package's, the resolution order of
`init_fleet` (the spec, APHANTASIA_FLEET, an initialised group), and the
repair of the fleet variable: with only APHANTASIA_FLEET set, illustra
renders its own scenes, each from a fresh start, as JAX illustra does.
Scenes and frames of a fleet equal, bit for bit, those of one process
(`--separate` for illustra, whose scenes then also start fresh)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from aphantasia_tpu.parallel import multihost as jmh
from aphantasia_torch.cli import illustra, interpol
from aphantasia_torch.io.checkpoint import load_pt
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.parallel import multihost as tmh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_illustra.py's tiny ViT-B/32
TINY_B32 = dict(name="ViT-B/32", embed_dim=512, image_resolution=224,
                vision_layers=1, vision_width=64, vision_patch_size=32,
                transformer_width=64, transformer_heads=1,
                transformer_layers=1)
TINY = ["--size", "48-48", "--steps", "2", "--samples", "2", "-nv",
        "--transform", "none", "--device", "cpu", "--aest", "0",
        "--lsteps", "2"]
NAMES = ["0001-one-ViTB32", "0002-two-ViTB32", "0003-three-ViTB32"]


@pytest.fixture
def fresh_fleet(monkeypatch):
    """No fleet resolved yet and no APHANTASIA_FLEET, undone after."""
    monkeypatch.setattr(tmh, "_FLEET", None)
    monkeypatch.setattr(tmh, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    monkeypatch.delenv("APHANTASIA_FLEET_WAIT", raising=False)
    monkeypatch.setitem(tm.CLIP_CONFIGS, "ViT-B/32",
                        tm.CLIPConfig(**TINY_B32))
    return monkeypatch


@pytest.mark.parametrize("count,world", [
    (0, 2), (1, 1), (1, 3), (2, 5), (3, 2), (4, 4), (5, 2), (6, 3), (7, 4),
    (9, 8), (10, 3), (12, 5)])
def test_shard_scenes_matches_jax(count, world):
    """Every rank's scene set equals JAX's; together they cover each scene
    once."""
    got = [tmh.shard_scenes(count, r, world) for r in range(world)]
    assert got == [jmh.shard_scenes(count, r, world) for r in range(world)]
    assert sorted(sum(got, [])) == list(range(count))


def test_parse_fleet_matches_jax():
    for spec in ("0/1", "2/4", "1/2@localhost:1234", " 3/5@h:9 "):
        assert tmh.parse_fleet(spec) == jmh.parse_fleet(spec)
    for bad in ("", "3", "2/2", "-1/2", "a/b", "0/0"):
        with pytest.raises(ValueError):
            tmh.parse_fleet(bad)
        with pytest.raises(ValueError):
            jmh.parse_fleet(bad)


def test_init_fleet_resolution(fresh_fleet, capsys):
    """The spec, else the variable, else an initialised group of more than
    one process, else 0/1; a spec that disagrees with such a group yields
    to it; the result stays until reset."""
    mp = fresh_fleet
    assert tmh.init_fleet() == (0, 1)
    tmh._reset_for_tests()
    mp.setenv("APHANTASIA_FLEET", "1/3")
    assert tmh.init_fleet() == (1, 3) and tmh.fleet_info() == (1, 3)
    assert not tmh.is_primary() and tmh.shard_scenes(7) == [1, 4]
    assert tmh.init_fleet("0/2") == (1, 3)             # resolved once
    tmh._reset_for_tests()
    assert tmh.init_fleet("2/4") == (2, 4)             # the spec wins
    tmh._reset_for_tests()
    mp.delenv("APHANTASIA_FLEET")
    mp.setattr(tmh, "_group_coords", lambda: (1, 2))
    assert tmh.init_fleet() == (1, 2)
    tmh._reset_for_tests()
    assert tmh.init_fleet("0/3") == (1, 2)
    assert "disagrees" in capsys.readouterr().out


def _scenes(tmp_path):
    path = tmp_path / "scenes.txt"
    path.write_text("one\ntwo\nthree\n")
    return str(path)


def test_fleet_variable_alone_takes_own_scenes(tmp_path, fresh_fleet,
                                               capsys):
    """APHANTASIA_FLEET=1/2 alone: illustra renders scene 2 of 3 only, from
    a fresh start, and does not assemble; then APHANTASIA_FLEET=0/2 renders
    scenes 1 and 3, each fresh, and rank 0 assembles the piece from the
    three snapshots.  Each snapshot equals a one-process --separate run's."""
    mp = fresh_fleet
    txt, out, ref = _scenes(tmp_path), str(tmp_path / "f"), str(tmp_path / "s")
    mp.setenv("APHANTASIA_FLEET", "1/2")
    res1 = illustra.run(illustra.get_args(["-t", txt, "--out_dir", out]
                                          + TINY))
    assert "fleet 1/2: scenes [1] of 3" in capsys.readouterr().out
    assert res1.out_names == NAMES[1:2] and res1.final_frames == 0
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        NAMES[1] + ".pt"]
    assert not os.path.exists(os.path.join(out, "_final"))
    tmh._reset_for_tests()
    mp.setenv("APHANTASIA_FLEET", "0/2")
    res0 = illustra.run(illustra.get_args(["-t", txt, "--out_dir", out]
                                          + TINY))
    assert "fleet 0/2: scenes [0, 2] of 3" in capsys.readouterr().out
    assert res0.out_names == [NAMES[0], NAMES[2]]
    assert res0.final_frames == 6 and res0.video is not None
    assert os.path.isfile(os.path.join(out, NAMES[0] + ".txt"))
    tmh._reset_for_tests()
    mp.delenv("APHANTASIA_FLEET")
    one = illustra.run(illustra.get_args(
        ["-t", txt, "--out_dir", ref, "--separate", "--save_pt"] + TINY))
    assert one.out_names == NAMES
    for n in NAMES:
        np.testing.assert_array_equal(load_pt(os.path.join(out, n + ".pt")),
                                      load_pt(os.path.join(ref, n + ".pt")))


def _snapshots(tmp_path, n=3):
    ptdir = tmp_path / "pt"
    ptdir.mkdir()
    rs = np.random.RandomState(0)
    for i in range(n):
        torch.save(torch.tensor(0.01 * rs.randn(1, 3, 32, 17, 2),
                                dtype=torch.float32), ptdir / f"{i}.pt")
    return str(ptdir)


def _frames(out):
    d = os.path.join(out, "a")
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_interpol_fleet_matches_one_process(tmp_path, fresh_fleet):
    """--fleet 1/2 renders the transition from snapshot 2 (and removes its
    frames of an earlier run first), APHANTASIA_FLEET=0/2 those from
    snapshots 1 and 3 and assembles: the frames equal one process's, byte
    for byte; rank 1 returns no video."""
    mp = fresh_fleet
    ptdir = _snapshots(tmp_path)
    fleet_out, one_out = str(tmp_path / "fo"), str(tmp_path / "oo")
    os.makedirs(os.path.join(fleet_out, "a"))
    stale = os.path.join(fleet_out, "a", "00002.jpg")
    open(stale, "wb").write(b"stale")
    args = ["-i", ptdir, "-s", "2", "-v", "", "--device", "cpu"]
    assert interpol.main(args + ["-o", fleet_out, "--fleet", "1/2"]) is None
    got = _frames(fleet_out)
    assert sorted(got) == ["00002.jpg", "00003.jpg"]
    assert got["00002.jpg"] != b"stale"
    tmh._reset_for_tests()
    mp.setenv("APHANTASIA_FLEET", "0/2")
    assert interpol.main(args + ["-o", fleet_out]) is not None
    tmh._reset_for_tests()
    mp.delenv("APHANTASIA_FLEET")
    interpol.main(args + ["-o", one_out])
    assert _frames(fleet_out) == _frames(one_out)
    assert len(_frames(one_out)) == 6


def test_interpol_fleet_with_a_coordinator(tmp_path):
    """Two processes with `--fleet R/2@127.0.0.1:PORT` join one gloo group
    and share the transitions; rank 0 assembles once rank 1's frames are
    in (APHANTASIA_FLEET_WAIT)."""
    ptdir = _snapshots(tmp_path, 2)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = str(tmp_path / "o")
    env = dict(os.environ, PYTHONPATH=ROOT, APHANTASIA_FLEET_WAIT="60")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "aphantasia_torch.cli.interpol", "-i", ptdir,
         "-o", out, "-s", "2", "--device", "cpu",
         "--fleet", f"{r}/2@127.0.0.1:{port}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    assert sorted(_frames(out)) == ["%05d.jpg" % i for i in range(4)]
    assert os.path.isfile(ptdir + "-pts.mp4") or os.path.isfile(
        ptdir + "-pts.avi")
