"""The port's host-spanning data axis (aphantasia_torch/parallel/dcn.py) on
the CPU, over gloo: the witness step as 2 host processes x 2 ranks and as
1 process x 4 ranks (`python -m aphantasia_torch.parallel.dcn`), and on
JAX's own inputs against JAX `witness_step` on a 4-device
`make_mesh_dcn(n_local=4)` of the conftest's virtual CPU devices; and
clip_fft's --mesh dcn (the one-host data axis), --mesh 2 and --mesh 2x2
through the CLI's launch against its dense run.

Tolerances: the layouts of the port agree to 1e-6 relative in the loss
and the digest (the same ranks in the same order).  Against JAX the
`fast` pipeline warps in bf16 in both packages: the loss within 2e-3
relative (test_torch_step.py's `fast` case), the digest (sum |params|
after one adam_custom step, each element moved by about the learning
rate) within 1e-3 relative."""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from aphantasia_torch.parallel import dcn as tdcn
from aphantasia_torch.parallel.mesh import Plan, free_port, spawn

from _torch_parity import jax_step_draws, tree_np
import _torch_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host(rank, world, coord, n_local, out):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "aphantasia_torch.parallel.dcn", str(rank),
         str(world), coord, str(n_local), str(out), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(procs):
    try:
        return [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _jax_witness():
    """JAX `witness_step` on 4 virtual devices, and its inputs."""
    import dataclasses
    from aphantasia_tpu.models.clip.model import CLIPConfig, clip_init
    from aphantasia_tpu.ops.sampler import CutoutSampler
    from aphantasia_tpu.params.fft import FFTParameterizer
    from aphantasia_tpu.parallel import dcn
    from aphantasia_tpu.parallel.step import StepSettings
    mesh = dcn.make_mesh_dcn(n_local=4)
    assert dict(mesh.shape) == {"data": 4}
    loss, digest = dcn.witness_step(mesh)
    jcfg = CLIPConfig(**dataclasses.asdict(tdcn._tiny()))
    par = FFTParameterizer((48, 48), decay_power=1.5, colors=1.8)
    sampler = CutoutSampler((48, 48), 8, 32, align="uniform", macro=0.4)
    settings = StepSettings(sim="mix", transform="fast", total_steps=10)
    params = np.asarray(par.init(jax.random.PRNGKey(1)))
    inputs = dict(
        clip=tree_np(clip_init(jax.random.PRNGKey(0), jcfg)), params=params,
        embs=np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 32))),
        draws=jax_step_draws(jax.random.PRNGKey(3), sampler, settings,
                             params.shape))
    return loss, digest, inputs


def test_witness_layouts_agree_and_match_jax(tmp_path):
    """2 processes x 2 ranks (a gloo fleet group over localhost, then the
    4-rank data group) and 1 process x 4 ranks give one loss and digest;
    the witness on JAX's inputs matches JAX's."""
    port = free_port()
    procs = [_host(r, 2, f"127.0.0.1:{port}", 2, tmp_path / f"r{r}.json")
             for r in range(2)]
    procs.append(_host(0, 1, "none", 4, tmp_path / "single.json"))
    jl, jd, inputs = _jax_witness()
    got = spawn(_torch_dist.witness_worker, (inputs,),
                Plan(4, f"127.0.0.1:{free_port()}", "cpu"))
    outs = _finish(procs)
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    recs = [json.loads((tmp_path / f).read_text())
            for f in ("r0.json", "r1.json", "single.json")]
    for r in recs:
        assert r["n_devices"] == 4 and r["mesh"] == {"data": 4}
    assert [r["n_local"] for r in recs] == [2, 2, 4]
    assert recs[0]["loss"] == recs[1]["loss"]
    assert recs[0]["digest"] == recs[1]["digest"]
    np.testing.assert_allclose(recs[0]["loss"], recs[2]["loss"], rtol=1e-6)
    np.testing.assert_allclose(recs[0]["digest"], recs[2]["digest"],
                               rtol=1e-6)
    # every rank of the spawn agrees, and the seeded step is the CLI's
    assert all(g == got[0] for g in got)
    (tl, td), seeded = got[0]
    np.testing.assert_allclose(seeded, (recs[2]["loss"], recs[2]["digest"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    np.testing.assert_allclose(td, jd, rtol=1e-3)


def test_uneven_hosts_raise(tmp_path):
    """Hosts with 2 and 1 ranks: both refuse (the JAX package would keep
    one rank of the first host)."""
    port = free_port()
    procs = [_host(r, 2, f"127.0.0.1:{port}", 2 - r, tmp_path / f"r{r}.json")
             for r in range(2)]
    outs = _finish(procs)
    for p, text in zip(procs, outs):
        assert p.returncode != 0 and "uneven hosts" in text, text[-3000:]
    assert not any((tmp_path / f"r{r}.json").exists() for r in range(2))


@pytest.mark.parametrize("argv,err,match", [
    (["0", "1", "none", "2", "OUT", "spatial", "--device", "cpu"],
     None, "spatial"),
    (["0", "1", "none", "2", "OUT", "other", "--device", "cpu"],
     ValueError, "mode")])
def test_witness_modes(tmp_path, argv, err, match):
    """The spatial witness runs: one host's two ranks split into data 2
    (the JAX witness's one-host anchor; its numbers are held to JAX in
    tests/test_torch_spatial.py); an unknown mode raises."""
    argv = [str(tmp_path / "o.json") if a == "OUT" else a for a in argv]
    if err is None:
        assert tdcn.main(argv) == 0
        rec = json.loads((tmp_path / "o.json").read_text())
        assert rec["mesh"] == {"data": 2, match: 1}
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["digest"])
        return
    with pytest.raises(err, match=match):
        tdcn.main(argv)


def test_plan_one_host(monkeypatch):
    """One host: the coordinator's address when the fleet gave one, else a
    free local port; the ranks are the argument's, or one on the CPU."""
    from aphantasia_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_FLEET", (0, 1))
    monkeypatch.setattr(multihost, "_COORD", "127.0.0.1:4567")
    plan = tdcn.plan_dcn(3, "cpu")
    assert (plan.n_local, plan.addr, plan.world) == (3, "127.0.0.1:4567", 3)
    monkeypatch.setattr(multihost, "_COORD", None)
    plan = tdcn.plan_dcn(device="cpu")
    assert plan.n_local == 1 and plan.addr.startswith("127.0.0.1:")
    monkeypatch.setattr(multihost, "_FLEET", (0, 2))
    with pytest.raises(ValueError, match="coordinator"):
        tdcn.plan_dcn(1, "cpu")


def test_clip_fft_mesh_matches_dense(tmp_path, monkeypatch):
    """clip_fft through `common.run_cli` (the CLI's launch) with --device
    cpu, on ViT-B/32's
    geometry cut to one block of width 128, two heads a tower
    (`_torch_dist.TINY_MESH_B32`, which each spawned rank sets through
    `_torch_dist.tiny_clip_fft`, clip_fft's run body): --mesh dcn (one
    rank, in this process), --mesh 2 and --mesh 2x2 (spawned gloo ranks,
    the last with the CLIP blocks tensor-parallel over 2) write the dense
    run's files, from rank 0, and its final params: dcn bit for bit; 2
    and 2x2 with the losses within 1e-5 relative and the params within
    2e-3 of the learning rate in the mean, with at most one element in a
    thousand off by more than 1e-2 of it (adam_custom moves an element by
    about the learning rate times the sign of its gradient, so a
    near-zero gradient summed in another order may move it the other
    way).  No child is left."""
    import multiprocessing
    from aphantasia_torch.cli import clip_fft
    from aphantasia_torch.cli.common import run_cli
    from aphantasia_torch.io.checkpoint import load_pt
    from aphantasia_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_FLEET", None)
    monkeypatch.setattr(multihost, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    from aphantasia_torch.models.clip import model as tm
    monkeypatch.setitem(tm.CLIP_CONFIGS, "ViT-B/32",
                        tm.CLIPConfig(**_torch_dist.TINY_MESH_B32))
    tiny = ["--size", "96-64", "--samples", "4", "--steps", "2", "-nv",
            "--device", "cpu", "--save_pt", "-tf", "none"]
    runs = {}
    for mesh in (None, "dcn", "2", "2x2"):
        out = str(tmp_path / str(mesh))
        a = clip_fft.get_args(["-t", "x", "--out_dir", out] + tiny
                              + (["--mesh", mesh] if mesh else []))
        res = run_cli(a, _torch_dist.tiny_clip_fft)
        runs[mesh] = (res, sorted(os.listdir(out)),
                      load_pt(os.path.join(out, res.out_name + ".pt"))[0])
    ref, files, p0 = runs[None]
    assert files == ["x-ViTB32", "x-ViTB32-2.jpg", "x-ViTB32.mp4",
                     "x-ViTB32.pt"]
    np.testing.assert_array_equal(runs["dcn"][2], p0)
    assert runs["dcn"][0].losses == ref.losses
    for mesh in ("2", "2x2"):
        res, got_files, p = runs[mesh]
        assert got_files == files
        assert sorted(os.listdir(tmp_path / mesh / "x-ViTB32")) == sorted(
            os.listdir(tmp_path / "None" / "x-ViTB32"))
        np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-5)
        err = np.abs(p - p0)
        assert err.mean() <= 2e-3 * 0.05, err.mean()
        assert (err > 1e-2 * 0.05).mean() <= 1e-3
    assert multiprocessing.active_children() == []
