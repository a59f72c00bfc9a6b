"""The port's illustra and interpol (aphantasia_torch/cli/illustra.py,
cli/interpol.py) and the pieces they add to the step: the centred
spectrum noise, the "step" step index and the crossfade renderer
`build_shift_render_loop`, each against the JAX package on the CPU; the
`.pt` interchange between both packages; a two-scene chain with the keep
rescale against JAX's `build_train_loop_frames(..., step_index='step')`;
and both CLIs end to end at a tiny size (`--device cpu`)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.params.fft import FFTParameterizer as JFFT
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import illustra, interpol
from aphantasia_torch.convert import (clip_params_from_numpy,
                                      fft_params_from_numpy,
                                      opt_state_from_optax)
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer

from _torch_parity import jax_step_draws, tree_np

CFG_KW = dict(name="tiny", embed_dim=32, image_resolution=32,
              vision_layers=2, vision_width=128, vision_patch_size=8,
              transformer_width=64, transformer_heads=2, transformer_layers=2)
# ViT-B/32's and ViT-B/16's geometry cut to one block of width 64 in each
# tower (tests/test_torch_cli.py's TINY_B32 pattern), with the published
# embedding width of 512, which the aesthetic heads take
TINY_B32 = dict(name="ViT-B/32", embed_dim=512, image_resolution=224,
                vision_layers=1, vision_width=64, vision_patch_size=32,
                transformer_width=64, transformer_heads=1,
                transformer_layers=1)
TINY_B16 = dict(TINY_B32, name="ViT-B/16", vision_patch_size=16)
TINY = ["--size", "48-48", "--steps", "2", "--samples", "2", "-nv",
        "--transform", "none", "--device", "cpu"]


@pytest.fixture
def tiny_towers(monkeypatch):
    for kw in (TINY_B32, TINY_B16):
        monkeypatch.setitem(tm.CLIP_CONFIGS, kw["name"], tm.CLIPConfig(**kw))


@pytest.mark.parametrize("centered", [False, True])
def test_noise_draw_matches_jax_noise_shift(centered, monkeypatch):
    """The same uniform values in (JAX's, fed to the port's draw in place
    of torch.rand), the same shift out: noise * u, or noise * (u - 0.5)
    with `noise_centered`, as JAX `_noise_shift`."""
    shape = (1, 3, 12, 9, 2)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (1, 1, 12, 9, 1)))
    want = jstep._noise_shift(key, jstep.StepSettings(
        noise=0.3, noise_centered=centered), shape)
    rand = torch.rand

    def fed(shape, *args, **kw):
        return (torch.tensor(u) if shape == u.shape
                else rand(shape, *args, **kw))
    monkeypatch.setattr(torch, "rand", fed)
    sett = tstep.StepSettings(noise=0.3, noise_centered=centered,
                              transform="none")
    got = tstep.build_draw_fn(CutoutSampler((12, 16), 2, 8), sett,
                              shape)(torch.Generator())
    np.testing.assert_array_equal(got.shift.numpy(), np.asarray(want))


def test_sample_budget_is_the_jax_cascade(monkeypatch):
    """`sample_budget` against the cascade that JAX illustra's `run`
    computes (cli/illustra.py:122-134), read from `a.samples` where that
    run stops at its next call (the aesthetic check), for every model and
    the flags of the cascade."""
    from aphantasia_tpu.cli import illustra as jill
    from aphantasia_tpu.parallel import multihost

    class Stop(Exception):
        pass

    class FakeClip:
        def __init__(self, *args, **kw):
            self.modsize = 224

    def stop(_):
        raise Stop
    monkeypatch.setattr(jill, "apply_platform", lambda: None)
    monkeypatch.setattr(multihost, "init_fleet", lambda spec=None: (0, 1))
    monkeypatch.setattr(jill, "ClipWrapper", FakeClip)
    monkeypatch.setattr(jill, "aesthetic_dims", stop)
    for model in illustra.CLIP_MODELS:
        for flags in ([], ["-tf", "none"], ["-e", "0.3"],
                      ["-dm", "2", "-tf", "none", "-e", "0.1"]):
            argv = ["-m", model, "--samples", "200"] + flags
            a = jill.get_args(argv)
            with pytest.raises(Stop):
                jill.run(a)
            b = illustra.get_args(argv)
            assert illustra.sample_budget(b.samples, b.model, b.dualmod,
                                          b.transform, b.enforce) == a.samples


@pytest.mark.parametrize("vsteps,nf", [(5, 5), (6, 3)])
def test_shift_render_loop_matches_jax(vsteps, nf):
    """The batched crossfade against JAX's scanned loop on the same
    spectrum and `diff`: uint8 frames within 1 level everywhere and equal
    on at least 99.9% of pixels."""
    h, w = 40, 56
    rs = np.random.RandomState(8)
    p1 = (0.07 * rs.randn(1, 3, h, w // 2 + 1, 2)).astype(np.float32)
    p2 = (0.07 * rs.randn(1, 3, h, w // 2 + 1, 2)).astype(np.float32)
    jloop = jstep.build_shift_render_loop(JFFT((h, w), 1.5, 1.8), 1.1)
    tloop = tstep.build_shift_render_loop(FFTParameterizer((h, w), 1.5, 1.8),
                                          1.1)
    for c in range(0, vsteps, nf):
        xs = np.arange(c, c + nf, dtype=np.float32) / vsteps
        want = np.asarray(jloop(jnp.asarray(p1), jnp.asarray(p2 - p1),
                                jnp.asarray(xs)))
        got = tloop(torch.tensor(p1), torch.tensor(p2 - p1),
                    torch.tensor(xs)).numpy()
        assert got.shape == want.shape == (nf, h, w, 3)
        assert got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_pt_interchange_with_jax(tmp_path):
    """A spectrum written by JAX `save_pt` loads with the port's `load_pt`
    exactly, and the reverse, as a bare tensor (illustra) and as a list
    (clip_fft)."""
    from aphantasia_tpu.io import checkpoint as jck
    from aphantasia_torch.io import checkpoint as tck
    p = np.random.RandomState(9).randn(1, 3, 16, 9, 2).astype(np.float32)
    for obj in (p, [p]):
        jck.save_pt(str(tmp_path / "j.pt"), obj)
        tck.save_pt(str(tmp_path / "t.pt"), obj if isinstance(obj, list)
                    else torch.tensor(obj))
        for got in (tck.load_pt(str(tmp_path / "j.pt")),
                    jck.load_pt(str(tmp_path / "t.pt"))):
            got = got[0] if isinstance(obj, list) else got
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, p)


def test_illustra_chain_matches_jax():
    """Two scenes of the port's scene function (`SceneLoop.scene`, the
    chunked path: 4 steps, 2 a frame, 2 frames a dispatch) on the JAX
    draws (step g of a scene from fold_in(k_scene, g)) against JAX's
    `build_train_loop_frames(..., step_index='step')`, with the centred
    spectrum noise; between them the keep rescale of JAX
    cli/illustra.py:297-298 on both sides, the optimizer state carried
    over, a zero `prev_enc` and the second scene's prompts.  After each
    scene, the ViT step's tolerances (tests/test_torch_step.py): losses
    1e-4 relative, params 2e-3 of the learning rate in the mean and 5e-2
    at the worst element; the port's carried Adam moment against the
    optax state's (`opt_state_from_optax`) within 1e-5 of its max."""
    lr, h, w, s, keep = 0.05, 48, 64, 4, 1.5
    jcfg, tcfg = jm.CLIPConfig(**CFG_KW), tm.CLIPConfig(**CFG_KW)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    tclip = clip_params_from_numpy(tree_np(jclip))
    rs = np.random.RandomState(1)
    p0 = (0.07 * rs.randn(1, 3, h, w // 2 + 1, 2)).astype(np.float32)
    embs = [rs.randn(2, 32).astype(np.float32) for _ in range(2)]
    wts = np.asarray([1.0, 0.5], np.float32)
    kw = dict(sim="mix", noise=0.1, noise_centered=True, total_steps=2,
              transform="none")
    jset = jstep.StepSettings(clip_dtype=jnp.float32, **kw)
    tset = tstep.StepSettings(clip_dtype=torch.float32, **kw)
    jsam = JSampler((h, w), s, 32, "uniform", 0.4)
    tsam = CutoutSampler((h, w), s, 32, "uniform", 0.4)
    jopt = jo.build_optimizer("adam_custom", lr)
    topt = to.build_optimizer("adam_custom", lr)
    jloop = jstep.build_train_loop_frames(JFFT((h, w), 1.5, 1.8), jsam, jcfg,
                                          jset, jopt, 2, 2, contrast=1.1,
                                          step_index="step")
    scenes = illustra.SceneLoop(FFTParameterizer((h, w), 1.5, 1.8), tsam,
                                [tcfg], tset, topt, 4, 2, 1.1)
    assert scenes.chunked and scenes.nf == 2
    jp, tp = jnp.asarray(p0), fft_params_from_numpy(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    key = jax.random.PRNGKey(11)
    for num in range(2):
        if num:
            jp = jnp.asarray(keep * np.asarray(jp)
                             / (np.asarray(jp).max() - np.asarray(jp).min()))
            tp = illustra.keep_chain(tp, keep)
        k_scene = jax.random.fold_in(key, num)
        jprompts = ((jnp.asarray(embs[num]), jnp.asarray(wts),
                     jnp.float32(-1.0)),)
        jp, js, _, _, jl = jloop(jp, js, jnp.zeros((s, 32)), jclip, None,
                                 None, jprompts, k_scene, jnp.int32(0))
        tprompts = [(torch.tensor(embs[num]), torch.tensor(wts), -1.0)]
        tp, ts, tl, _ = scenes.scene(
            tp, ts, [(tclip, None, None, tprompts)],
            lambda g, k=k_scene: jax_step_draws(jax.random.fold_in(k, g),
                                                jsam, jset, p0.shape))
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4, atol=1e-4)
        err = np.abs(tp.numpy() - np.asarray(jp))
        assert err.mean() <= 2e-3 * lr, (num, err.mean())
        assert err.max() <= 5e-2 * lr, (num, err.max())
        nu = opt_state_from_optax(js).nu.numpy()
        assert np.abs(ts.nu.numpy() - nu).max() <= 1e-5 * np.abs(nu).max()
    assert len(scenes.loops) == 1      # the second scene reused the loop


def test_scene_dispatch_by_dispatch_equals_the_scene(monkeypatch):
    """A scene driven dispatch by dispatch through `SceneLoop.dispatch`
    (3 dispatches of 2 frames, a frame a step) gives the parameters, the
    optimizer state, the losses and the frames of `SceneLoop.scene` on
    the same draws, bit for bit: `scene` is those calls in order."""
    monkeypatch.setattr(illustra, "frames_per_dispatch", lambda size, n: 2)
    h, w, s = 32, 48, 3
    cfg = tm.CLIPConfig(**CFG_KW)
    clip = tm.clip_init(torch.Generator().manual_seed(2), cfg)
    p0 = FFTParameterizer((h, w), 1.5, 1.8).init(
        torch.Generator().manual_seed(3))
    prompts = [(torch.randn((2, 32), generator=torch.Generator()
                            .manual_seed(4)), torch.tensor([1.0, 0.5]),
                -1.0)]
    sett = tstep.StepSettings(sim="mix", total_steps=6, transform="fast")
    outs = []
    for by_dispatch in (False, True):
        sam = CutoutSampler((h, w), s, 32, "uniform", 0.4)
        scenes = illustra.SceneLoop(FFTParameterizer((h, w), 1.5, 1.8), sam,
                                    [cfg], sett,
                                    to.build_optimizer("adam_custom", 0.05),
                                    6, 1, 1.1)
        assert scenes.chunked and (scenes.nf, scenes.dispatches) == (2, 3)
        draw = tstep.build_draw_fn(sam, sett, tuple(p0.shape))
        gen = torch.Generator().manual_seed(5)
        frames = {}

        def save(first, fr):
            for j in range(len(fr)):
                frames[first + j] = fr[j].clone()
        p, st = p0.clone(), scenes.optimizer.init(p0.clone())
        consts = [(clip, None, None, prompts)]

        def feed(g, gen=gen):
            return draw(gen)
        if by_dispatch:
            prev, losses = torch.zeros((s, 32)), []
            for c in range(scenes.dispatches):
                p, st, prev, dl = scenes.dispatch(c, p, st, prev, consts,
                                                  feed, save)
                losses += dl
        else:
            p, st, losses, _ = scenes.scene(p, st, consts, feed, save)
        outs.append((p, st, losses, frames))
    (pa, sa, la, fa), (pb, sb, lb, fb) = outs
    assert torch.equal(pa, pb) and torch.equal(sa.nu, sb.nu)
    assert la == lb and len(la) == 6
    assert sorted(fa) == sorted(fb) == list(range(6))
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_step_index_names():
    """"step" (the JAX name) and "global" both give the loss the global
    step (a stride through a frame group); anything else raises."""
    par, sam = FFTParameterizer((16, 16)), CutoutSampler((16, 16), 2, 8)
    args = (par, sam, tm.CLIPConfig(**CFG_KW), tstep.StepSettings(),
            to.build_optimizer("adam", 0.1), 2, 1)
    for name, stride in (("frame", False), ("step", True),
                         ("global", True)):
        loop = tstep.build_train_loop_frames(*args, step_index=name)
        assert loop._group(loop.pattern(0)).stride is stride
    with pytest.raises(ValueError, match="step_index"):
        tstep.build_train_loop_frames(*args, step_index="scene")


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_illustra_two_scenes_cpu(tmp_path, tiny_towers):
    """Two scenes from a text file (a comment line skipped) and the
    crossfade at --lsteps 3: a `.pt` a scene (a bare spectrum), 6 `_final`
    frames, each scene's frames, last frame and mp4, the run's config,
    and the crossfade video named after the text file (JAX
    tests/test_cli_video.py:10-22)."""
    txt = _write(tmp_path / "lines.txt", "first scene\n# comment\nsecond scene\n")
    out = str(tmp_path / "fft")
    res = illustra.run(illustra.get_args(
        ["-t", txt, "--out_dir", out, "--lsteps", "3", "--aest", "0"] + TINY))
    names = ["0001-first_scene-ViTB32", "0002-second_scene-ViTB32"]
    assert res.out_names == names and res.samples == 1   # 2 x 1.05 x 0.95
    pts = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    assert pts == [n + ".pt" for n in names]
    from aphantasia_tpu.io.checkpoint import load_pt
    snap = load_pt(os.path.join(out, pts[1]))
    assert snap.shape == (1, 3, 48, 25, 2)
    np.testing.assert_array_equal(snap, res.params.numpy())
    finals = [f for f in os.listdir(os.path.join(out, "_final"))
              if f.endswith(".jpg")]
    assert len(finals) == 6 == res.final_frames
    for n in names:
        assert sorted(os.listdir(os.path.join(out, n))) == ["0000.jpg",
                                                           "0001.jpg"]
        assert os.path.isfile(os.path.join(out, n + "-2.jpg"))
    assert "in_txt: " + txt in open(os.path.join(out, names[0] + ".txt")).read()
    assert res.video is not None and os.path.basename(res.video).startswith(
        "lines.")
    assert all(np.isfinite(l).all() for l in res.losses)


def test_illustra_separate_dualmod_cpu(tmp_path, tiny_towers):
    """--separate --dualmod 2 through the chunked loop (steps 4, save_step
    2): the second tower (ViT-B/16) on step 2, a fresh init per scene,
    no snapshot and no crossfade, the dual out-name."""
    out = str(tmp_path / "outdm")
    argv = ["-t", "test prompt", "--out_dir", out, "--separate",
            "--dualmod", "2"] + TINY
    argv[argv.index("--steps") + 1] = "4"
    res = illustra.run(illustra.get_args(argv + ["--save_step", "2",
                                                 "--samples", "3"]))
    assert res.out_names == ["test_prompt"]
    assert res.scene_loop.chunked and res.video is None
    loop = next(iter(res.scene_loop.loops.values()))
    assert sorted(loop.groups) == [(0, 0), (1, 0)]
    frames = os.listdir(os.path.join(out, "test_prompt"))
    assert sorted(frames) == ["0000.jpg", "0001.jpg"]
    assert not [f for f in os.listdir(out) if f.endswith(".pt")]
    assert len(res.losses[0]) == 4 and np.isfinite(res.losses[0]).all()


def test_interpol_on_jax_snapshots(tmp_path):
    """interpol on two snapshots written by JAX `save_pt` (one bare, one a
    list): 6 frames at --steps 3, the size read from the spectrum, and the
    `<in_dir>-pts` video."""
    from aphantasia_tpu.io.checkpoint import save_pt
    ptdir = str(tmp_path / "pt")
    os.makedirs(ptdir)
    rs = np.random.RandomState(0)
    save_pt(os.path.join(ptdir, "0.pt"),
            rs.randn(1, 3, 32, 17, 2).astype(np.float32) * 0.01)
    save_pt(os.path.join(ptdir, "1.pt"),
            [rs.randn(1, 3, 32, 17, 2).astype(np.float32) * 0.01])
    out = str(tmp_path / "out")
    video = interpol.main(["-i", ptdir, "-o", out, "-s", "3", "-v", "",
                           "--device", "cpu"])
    frames = sorted(os.listdir(os.path.join(out, "a")))
    assert frames == ["%05d.jpg" % i for i in range(6)]
    from PIL import Image
    with Image.open(os.path.join(out, "a", frames[0])) as im:
        assert im.size == (32, 32)
    assert video is not None and os.path.basename(video).startswith("pt-pts.")


def _no_fleet(monkeypatch):
    """No fleet resolved and no APHANTASIA_FLEET, undone after the test."""
    from aphantasia_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_FLEET", None)
    monkeypatch.setattr(multihost, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    return multihost


@pytest.mark.parametrize("cli,flags", [
    ("illustra", ["--spatial", "2"]), ("illustra", ["--mesh", "dcn"]),
    ("illustra", ["--fleet", "0/2"]), ("interpol", ["--fleet", "0/2"])])
def test_unported_flags_raise(tmp_path, monkeypatch, tiny_towers, cli, flags):
    """--spatial, --mesh and --fleet, which raised until they were ported,
    pass: illustra --spatial 2 plans two gloo ranks, and with --mesh 2 a
    data axis of two over them, four, with --mesh 2x2 eight (D x M x S;
    its runs are held to JAX in tests/test_torch_spatial.py); illustra
    --mesh dcn (a data mesh of one rank in this process, its collectives
    included) gives the dense run's losses and spectrum bit for bit;
    illustra --fleet 0/2 renders scene 1 of 1 and assembles; interpol
    --fleet 0/2 gets past the fleet to the empty snapshot directory."""
    if flags[0] == "--spatial":
        from aphantasia_torch.cli.common import mesh_plan
        for mesh, ranks in ((None, 2), ("2", 4), ("2x2", 8)):
            a = illustra.get_args(["-t", "x", "--out_dir", str(tmp_path)]
                                  + TINY + flags
                                  + (["--mesh", mesh] if mesh else []))
            plan = mesh_plan(a.mesh, a.device, a.spatial)
            assert (plan.n_local, plan.world) == (ranks, ranks)
        return
    mh = _no_fleet(monkeypatch)
    if cli == "interpol":
        with pytest.raises(FileNotFoundError, match="no .pt snapshots"):
            interpol.main(["-i", str(tmp_path), "-o", str(tmp_path),
                           "--device", "cpu"] + flags)
        assert mh.fleet_info() == (0, 2)
        return
    argv = ["-t", "x", "--aest", "0", "--lsteps", "2"] + TINY
    res = illustra.run(illustra.get_args(
        argv + ["--out_dir", str(tmp_path / "m")] + flags))
    if flags[0] == "--fleet":
        assert mh.fleet_info() == (0, 2) and res.final_frames == 2
        return
    dense = illustra.run(illustra.get_args(
        argv + ["--out_dir", str(tmp_path / "d")]))
    assert res.losses == dense.losses
    assert torch.equal(res.params, dense.params)


def test_entry_points_raise_without_gpu(tmp_path, monkeypatch):
    """Both CLIs default to the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        illustra.main(["-t", "x", "--out_dir", str(tmp_path), "-nv"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interpol.main(["-i", str(tmp_path), "-o", str(tmp_path)])
