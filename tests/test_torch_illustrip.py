"""The port's illustrip (aphantasia_torch/cli/illustrip.py) and what it adds
to the package: the pixel generator, the loss's `rgb_anchors` and
`sharp_mode`, `intrl`, `get_encs`, `build_prompt_groups` and the video
frame step `build_frame_step`, each against the JAX package on the CPU
(the frame step on JAX's own draws); and the CLI end to end at a tiny
size (`--device cpu`): two RGB scenes, FFT `--smooth --noise 1` and
`--dualmod 2`, with the JAX CLI's sample budget, motion length and work
directory."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.params import pixel as jpixel
from aphantasia_tpu.params.fft import FFTParameterizer as JFFT
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import illustrip
from aphantasia_torch.cli.common import build_prompt_groups
from aphantasia_torch.convert import clip_params_from_numpy
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params import pixel as tpixel
from aphantasia_torch.params.fft import FFTParameterizer
from aphantasia_torch.utils import intrl, minmax

from _torch_parity import jax_step_draws, tree_np

CFG_KW = dict(name="tiny", embed_dim=32, image_resolution=32,
              vision_layers=2, vision_width=128, vision_patch_size=8,
              transformer_width=64, transformer_heads=2, transformer_layers=2)
# ViT-B/32's and ViT-B/16's geometry cut to one block of width 64 in each
# tower, with the published embedding width of 512
TINY_B32 = dict(name="ViT-B/32", embed_dim=512, image_resolution=224,
                vision_layers=1, vision_width=64, vision_patch_size=32,
                transformer_width=64, transformer_heads=1,
                transformer_layers=1)
TINY_B16 = dict(TINY_B32, name="ViT-B/16", vision_patch_size=16)
TINY = ["--size", "48-48", "--steps", "3", "--samples", "2", "-nv",
        "--transform", "none", "--device", "cpu", "--fstep", "2"]


@pytest.fixture
def tiny_towers(monkeypatch):
    for kw in (TINY_B32, TINY_B16):
        monkeypatch.setitem(tm.CLIP_CONFIGS, kw["name"], tm.CLIPConfig(**kw))


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_intrl_and_get_encs_match_jax():
    """minmax as JAX's; intrl puts every step-th element of the second
    list in, from index `step`; a step of 1 (`--dualmod 1`) fails its
    assert, as in JAX.
    get_encs's crossfade weights equal JAX's, and a string --interpol
    holds the scene's own encodings."""
    from aphantasia_tpu.cli import illustrip as jtrip
    from aphantasia_tpu.utils import intrl as jintrl, minmax as jminmax
    x = np.asarray([[0.5, -2.0], [3.0, 1.0]], np.float32)
    assert minmax(torch.tensor(x)) == minmax(x) == jminmax(x) == (-2.0, 3.0)
    assert intrl(list("abcdefg"), list("ABCDEFG"), 3) == jintrl(
        list("abcdefg"), list("ABCDEFG"), 3) == list("abcDefG")
    with pytest.raises(AssertionError):
        intrl([1, 2], [3, 4], 1)
    with pytest.raises(AssertionError):
        intrl([1, 2], [3], 2)
    rs = np.random.RandomState(0)
    encs = [(rs.randn(2, 8).astype(np.float32),
             np.asarray([1.0, 0.7], np.float32)) for _ in range(3)]
    for num in (0, 1, 2):
        want = jtrip.get_encs([(jnp.asarray(e), jnp.asarray(w))
                               for e, w in encs], num, 5)
        got = illustrip.get_encs([(torch.tensor(e), torch.tensor(w))
                                  for e, w in encs], num, 5)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert len(g) == len(w) == 2
            for (ge, gw), (we, ww) in zip(g, w):
                np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
                np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    held = illustrip.get_encs([(torch.tensor(e), torch.tensor(w))
                               for e, w in encs], 1, 4, interpol="0")
    assert len(held) == 4 and all(len(x) == 1 for x in held)
    np.testing.assert_array_equal(held[3][0][1].numpy(), encs[1][1])
    assert illustrip.get_encs([], 0, 4) == []


def test_build_prompt_groups_copies_and_makes_tensor_coeffs():
    embs, wts = torch.randn(2, 8), torch.tensor([1.0, 0.5])
    (g,) = build_prompt_groups([None, (embs, wts, -0.5)])
    assert g[0] is not embs and g[1] is not wts
    assert torch.equal(g[0], embs) and torch.equal(g[1], wts)
    assert g[2].shape == () and g[2].dtype == torch.float32
    assert g[2].item() == -0.5


@pytest.mark.parametrize("fixcontrast", [False, True])
def test_pixel_decode_and_image_match_jax(fixcontrast):
    """The decode (std with ddof 1, or / 3.3) and the color head."""
    p = np.random.RandomState(1).randn(1, 3, 12, 16).astype(np.float32)
    jp = jpixel.PixelParameterizer((12, 16), 2.3, fixcontrast)
    tp = tpixel.PixelParameterizer((12, 16), 2.3, fixcontrast)
    for fn in ("decode", "image"):
        want = np.asarray(getattr(jp, fn)(jnp.asarray(p), contrast=1.2))
        got = getattr(tp, fn)(torch.tensor(p), contrast=1.2).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pixel_resume_matches_jax(tmp_path):
    """An image resumes as 3.3 * un_rgb(image, colors=2.0) with its size;
    a random start is sd * randn of the shape; an array passes."""
    from PIL import Image
    arr = (np.random.RandomState(2).rand(10, 14, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "start.png")
    Image.fromarray(arr).save(path)
    want, wsz = jpixel.resume_pixel(path, None)
    got, gsz = tpixel.resume_pixel(path, None)
    assert tuple(gsz) == tuple(wsz) == (10, 14)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rnd, sz = tpixel.resume_pixel(None, (1, 3, 6, 5), sd=0.5,
                                  generator=torch.Generator().manual_seed(0))
    assert sz is None and rnd.shape == (1, 3, 6, 5)
    assert 0.2 < rnd.std().item() < 0.8
    lst, _ = tpixel.resume_pixel([np.ones((1, 3, 2, 2), np.float32)])
    assert lst.shape == (1, 3, 2, 2)
    with pytest.raises(FileNotFoundError):
        tpixel.resume_pixel(str(tmp_path / "missing.png"))


def _tiny_clip():
    jcfg, tcfg = jm.CLIPConfig(**CFG_KW), tm.CLIPConfig(**CFG_KW)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jclip, clip_params_from_numpy(tree_np(jclip))


@pytest.mark.parametrize("mode", ["naiv", "sobel", "scharr"])
def test_loss_with_rgb_anchors_and_sharp_mode_matches_jax(mode):
    """The RGB loss (pixel params, `rgb_anchors`, sharpness in each
    `sharp_mode`) on JAX's draws: loss within 1e-5 relative, gradient
    within 1e-4 relative L2."""
    h, w, s = 40, 48, 3
    jcfg, tcfg, jclip, tclip = _tiny_clip()
    p = np.random.RandomState(3).randn(1, 3, h, w).astype(np.float32)
    emb = np.random.RandomState(4).randn(2, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    kw = dict(sim="mix", sharp=0.3, sharp_mode=mode, rgb_anchors=True,
              transform="none")
    jset = jstep.StepSettings(clip_dtype=jnp.float32, **kw)
    tset = tstep.StepSettings(clip_dtype=torch.float32, **kw)
    jsam = JSampler((h, w), s, 32, "overscan", 0.3)
    tsam = CutoutSampler((h, w), s, 32, "overscan", 0.3)
    jpar = jpixel.PixelParameterizer((h, w), 2.3)
    tpar = tpixel.PixelParameterizer((h, w), 2.3)
    jloss = jstep.build_loss_fn(jpar, jsam, jcfg, jset)
    tloss = tstep.build_loss_fn(tpar, tsam, tcfg, tset)
    key = jax.random.PRNGKey(5)
    jprompts = ((jnp.asarray(emb), jnp.asarray(wts), jnp.float32(-1.0)),)
    (wl, _), wg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(p), jclip, None, None, jprompts, jnp.zeros((s, 32)), key,
        jnp.int32(0))
    x = torch.tensor(p, requires_grad=True)
    tl, _ = tloss(x, tclip, None, None, build_prompt_groups(
        [(torch.tensor(emb), torch.tensor(wts), -1.0)]), torch.zeros((s, 32)),
        jax_step_draws(key, jsam, jset, p.shape), 0)
    (tg,) = torch.autograd.grad(tl, x)
    assert abs(tl.item() - float(wl)) <= 1e-5 * abs(float(wl))
    wg = np.asarray(wg)
    assert np.linalg.norm(tg.numpy() - wg) <= 1e-4 * np.linalg.norm(wg)


@pytest.mark.parametrize("gen,smooth", [("RGB", False), ("FFT", False),
                                        ("FFT", True)])
def test_frame_step_matches_jax(gen, smooth):
    """Two consecutive frames of `build_frame_step` (opt_steps 2, the
    float32 `none` transform (the `fast` one warps in bf16 on both sides
    and is held at 2e-3 in tests/test_torch_step.py), centred spectrum
    noise for FFT, `rgb_anchors` for RGB) against JAX's (parallel/step.py:310), each frame from JAX's draws
    (`fold_in(k_frame, s)`), with its own motion and step index, the
    optimizer state fresh or with `smooth` carried: losses within 2e-4
    relative, the frame within 1 grey level, the params within the
    envelope JAX's own fused-against-unfused frame test states
    (tests/test_frame_loop.py: rtol 6e-3, atol 2.5e-2; Adam with b1 = 0
    turns float noise in a near-zero gradient element into a full-size
    update of that element)."""
    h, w, s, lr = 40, 48, 3, 0.05
    jcfg, tcfg, jclip, tclip = _tiny_clip()
    rs = np.random.RandomState(6)
    if gen == "RGB":
        p0 = rs.randn(1, 3, h, w).astype(np.float32)
        jpar = jpixel.PixelParameterizer((h, w), 2.3)
        tpar = tpixel.PixelParameterizer((h, w), 2.3)
    else:
        p0 = (0.01 * rs.randn(1, 3, h, w // 2 + 1, 2)).astype(np.float32)
        jpar, tpar = JFFT((h, w), 1.0, 2.3), FFTParameterizer((h, w), 1.0, 2.3)
    emb = rs.randn(2, 32).astype(np.float32)
    kw = dict(sim="mix", noise=2.0 if gen == "FFT" else 0.0,
              noise_centered=True, total_steps=3, rgb_anchors=gen == "RGB",
              transform="none")
    jset = jstep.StepSettings(clip_dtype=jnp.float32, **kw)
    tset = tstep.StepSettings(clip_dtype=torch.float32, **kw)
    jsam = JSampler((h, w), s, 32, "overscan", 0.3)
    tsam = CutoutSampler((h, w), s, 32, "overscan", 0.3)
    jopt = jo.build_optimizer("adam_custom", lr)
    topt = to.build_optimizer("adam_custom", lr)
    jfs = jstep.build_frame_step(jpar, jsam, jcfg, jset, jopt, gen, (h, w),
                                 2, smooth, contrast=1.2)
    tfs = tstep.build_frame_step(tpar, tsam, tcfg, tset, topt, gen, (h, w),
                                 2, smooth, contrast=1.2)
    jp, tp = jnp.asarray(p0), torch.tensor(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    jprev, tprev = jnp.zeros((s, 32)), torch.zeros((s, 32))
    key = jax.random.PRNGKey(7)
    for ii, motion in enumerate([(3.0, 1.5, -2.0, 1.02, 0.5),
                                 (-1.0, -0.7, 2.5, 0.99, -0.3)]):
        k = jax.random.fold_in(key, ii)
        wts = np.asarray([1.0 - 0.3 * ii, 0.3 * ii], np.float32)
        jprompts = ((jnp.asarray(emb), jnp.asarray(wts), jnp.float32(-1.0)),)
        jp, js, jprev, jframe, jl = jfs(
            jp, js, jprev, jclip, None, jprompts, k, jnp.int32(ii),
            tuple(jnp.float32(v) for v in motion))
        tp, ts, tprev, tframe, tl = tfs(
            tp, ts, tprev, tclip, None, build_prompt_groups(
                [(torch.tensor(emb), torch.tensor(wts), -1.0)]),
            [jax_step_draws(jax.random.fold_in(k, j), jsam, jset, p0.shape)
             for j in range(2)], ii, motion)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=1e-6)
        fd = np.abs(tframe.numpy().astype(int) - np.asarray(jframe).astype(int))
        assert tframe.shape == (h, w, 3) and fd.max() <= 1
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=6e-3,
                                   atol=2.5e-2)
        assert int(ts.count) == (2 * (ii + 1) if smooth else 2)
    assert len(tfs.groups) == 1        # the second frame reused the group


def test_frame_step_group_per_prompt_shape():
    """A frame whose prompts have another shape gets a group of its own,
    which shares the state of the first."""
    h, w = 16, 16
    par, sam = tpixel.PixelParameterizer((h, w)), CutoutSampler((h, w), 2, 8)
    cfg = tm.CLIPConfig(**dict(CFG_KW, image_resolution=8,
                               vision_patch_size=4))
    clip = tm.clip_init(torch.Generator().manual_seed(0), cfg)
    settings = tstep.StepSettings(transform="none")
    fs = tstep.build_frame_step(par, sam, cfg, settings,
                                to.build_optimizer("adam", 0.1), "RGB",
                                (h, w), 1, False)
    draw = tstep.build_draw_fn(sam, settings, (1, 3, h, w))
    g = torch.Generator().manual_seed(1)
    p = par.init(g)
    st, prev = to.build_optimizer("adam", 0.1).init(p), torch.zeros((2, 32))
    for k in (1, 2, 1):
        prompts = build_prompt_groups([(torch.randn(k, 32), torch.ones(k),
                                        -1.0)])
        p, st, prev, frame, losses = fs(p, st, prev, clip, None, prompts,
                                        [draw(g)], 0, (1.0, 0.5, 0.5, 1.01,
                                                       0.2))
        assert torch.isfinite(losses).all() and frame.dtype == torch.uint8
    assert len(fs.groups) == 2
    bufs = [grp.bufs for grp in fs.groups.values()]
    assert bufs[0].params is bufs[1].params and bufs[0].opt is bufs[1].opt


def test_sample_budget_fstep_and_workdir_match_jax(tmp_path, monkeypatch,
                                                   tiny_towers):
    """The JAX CLI's `run` up to its motion schedule (its towers faked,
    their encodings dummies) against the port's `setup`: the cutouts
    after the budget, the fstep adjustment (glob_steps == fstep), the
    work directory and its files."""
    from aphantasia_tpu.cli import illustrip as jtrip
    from aphantasia_tpu.parallel import multihost

    class Stop(Exception):
        pass

    class FakeClip:
        def __init__(self, name, *args, **kw):
            self.modsize = 224
            self.params = None
            self.cfg = jm.CLIPConfig(**dict(TINY_B32, name=name))

        def enc_text(self, t):
            return np.ones((1, 512), np.float32), np.ones((1,), np.float32)

    seen = {}

    def stop(glob_steps, fstep, *args, **kw):
        seen.update(glob_steps=glob_steps, fstep=fstep)
        raise Stop
    monkeypatch.setattr(jtrip, "apply_platform", lambda: None)
    monkeypatch.setattr(multihost, "init_fleet", lambda spec=None: (0, 1))
    monkeypatch.setattr(jtrip, "ClipWrapper", FakeClip)
    monkeypatch.setattr(jtrip, "motion_schedule", stop)
    txt = _write(tmp_path / "scenes.txt", "one\ntwo\n")
    for flags in (["--fstep", "6"], ["--gen", "FFT", "-dm", "2", "-e", "0.2"],
                  ["-m", "RN50", "-tf", "none", "--rem", "x"]):
        argv = ["-t", txt, "--size", "48-48", "--steps", "3", "-nv",
                "--samples", "40"] + flags
        a = jtrip.get_args(argv + ["--out_dir", str(tmp_path / "j")])
        with pytest.raises(Stop):
            jtrip.run(a)
        if "RN50" in flags:     # no tiny ResNet: the budget and names alone
            b = illustrip.get_args(argv + ["--out_dir", str(tmp_path / "t")])
            from aphantasia_torch.cli.common import apply_sample_budget
            assert apply_sample_budget(b.samples, b.model, b.dualmod,
                                       b.enforce, 0, b.transform) == a.samples
            continue
        b = illustrip.get_args(argv + ["--out_dir", str(tmp_path / "t"),
                                       "--device", "cpu"])
        su = illustrip.setup(b)
        assert (b.samples, b.fstep) == (a.samples, seen["fstep"])
        assert su.count * b.steps == seen["glob_steps"]
        jdir = sorted(os.listdir(tmp_path / "j"))[-1]
        assert os.path.basename(su.workdir) in os.listdir(tmp_path / "j")
        assert sorted(os.listdir(su.workdir)) == sorted(
            os.listdir(tmp_path / "j" / os.path.basename(su.workdir)))
        assert jdir


def _frames(workdir):
    return sorted(f for f in os.listdir(os.path.join(workdir, "ttt"))
                  if f.endswith(".jpg"))


def test_illustrip_two_scenes_rgb_cpu(tmp_path, tiny_towers):
    """Two RGB scenes (the second line with two `|` parts, so its frames
    take a second frame group from frame 3 on), --opt_step 2: six frames
    `%06d.jpg`, the config, the text file copied, the video, finite
    losses."""
    txt = _write(tmp_path / "lines.txt", "first scene\n# note\nsecond | two\n")
    res = illustrip.run(illustrip.get_args(
        ["-t", txt, "--out_dir", str(tmp_path / "o"), "--opt_step", "2"]
        + TINY))
    assert os.path.basename(res.workdir) == "lines-rgb"
    assert _frames(res.workdir) == ["%06d.jpg" % i for i in range(6)]
    for f in ("config.txt", "lines.txt"):
        assert os.path.isfile(os.path.join(res.workdir, f))
    assert res.video is not None and os.path.getsize(res.video) > 0
    assert res.frames == 6 and res.samples == 2       # no `fast` cut
    assert all(len(x) == 2 and np.isfinite(x).all() for x in res.losses)
    assert len(res.frame_steps[0].groups) == 2 and res.first_frames == [0, 3]


def test_illustrip_fft_smooth_noise_cpu(tmp_path, tiny_towers):
    res = illustrip.run(illustrip.get_args(
        ["-t", "tiny scene", "--out_dir", str(tmp_path / "o"), "--gen",
         "FFT", "--smooth", "--noise", "1"] + TINY))
    assert os.path.basename(res.workdir) == "tiny_scene-fft"
    assert _frames(res.workdir) == ["%06d.jpg" % i for i in range(3)]
    assert tuple(res.params.shape) == (1, 3, 48, 25, 2)
    assert all(np.isfinite(x).all() for x in res.losses)


def test_illustrip_dualmod_cpu(tmp_path, tiny_towers):
    """--dualmod 2 over 4 frames: frame 2 runs the ViT-B/16 frame step on
    the interleaved encodings, the others ViT-B/32."""
    argv = ["-t", "tiny scene", "--out_dir", str(tmp_path / "o"), "--gen",
            "FFT", "--dualmod", "2"] + TINY + ["--samples", "9"]
    argv[argv.index("--steps") + 1] = "4"
    res = illustrip.run(illustrip.get_args(argv))
    assert os.path.basename(res.workdir) == "tiny_scene-fft-dm2"
    assert res.samples == 2 and len(_frames(res.workdir)) == 4   # 9 x 0.23
    assert [len(fs.groups) for fs in res.frame_steps] == [1, 1]


def test_illustrip_prompt_flags_cpu(tmp_path, tiny_towers):
    """Every prompt source at once (-t, -pre, -post, -t2, -t0, -im with
    two images of a folder, so two scenes), --aest, --invert and a resume
    image (RGB: --fixcontrast, the image's size): two groups a source,
    the coefficients JAX's (-invert, -1 for styles, +1 for subtracts,
    -weight_img for images)."""
    from PIL import Image
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(3)
    for n in ("a", "b"):
        Image.fromarray((rs.rand(40, 40, 3) * 255).astype(np.uint8)).save(
            str(imgs / f"{n}.png"))
    start = str(tmp_path / "start.png")
    Image.fromarray((rs.rand(32, 40, 3) * 255).astype(np.uint8)).save(start)
    a = illustrip.get_args(
        ["-t", "topic", "-pre", "before", "-post", "after", "-t2", "style",
         "-t0", "not this", "-im", str(imgs), "--aest", "1", "--invert",
         "-r", start, "--out_dir", str(tmp_path / "o")] + TINY)
    su = illustrip.setup(a)
    assert a.fixcontrast and tuple(su.params.shape) == (1, 3, 32, 40)
    assert su.texts == ["before | topic | after"]
    assert su.towers[0][2] is not None          # the aesthetic head
    sched = su.scene(0)
    tower, prompts, motion = su.frame(sched, 0, 1)
    coeffs = [g[2].item() for g in prompts]
    # two scenes (two images); each source's scene fades into the next
    # (the last text, style and subtract into themselves)
    assert su.count == 2
    assert coeffs == [1.0] * 2 + [-1.0] * 2 + [1.0] * 2 + [-0.5] * 2
    assert prompts[0][0].shape == (3, 512) and len(motion) == 5
    res = illustrip.run(a)
    assert res.frames == 6 and all(np.isfinite(x).all() for x in res.losses)


def _no_fleet(monkeypatch):
    """No fleet resolved and no APHANTASIA_FLEET, undone after the test."""
    from aphantasia_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_FLEET", None)
    monkeypatch.setattr(multihost, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    return multihost


@pytest.mark.parametrize("flags", [["--spatial", "2"], ["--mesh", "dcn"],
                                   ["--fleet", "0/2"]])
def test_unported_flags_raise(tmp_path, monkeypatch, tiny_towers, flags):
    """--spatial, --mesh and --fleet, which raised until they were ported,
    pass: --spatial 2 plans two gloo ranks, and with --mesh dcn raises as
    in JAX (the spatial axis composes with 'N' and 'NxM' only; its runs
    are held to JAX in tests/test_torch_spatial.py); --mesh dcn (a data
    mesh of one rank in this process, its collectives included) gives the
    dense run's losses and last frame state bit for bit; --fleet 0/2 runs
    the whole job on this host."""
    if flags[0] == "--spatial":
        from aphantasia_torch.cli.common import mesh_plan
        a = illustrip.get_args(["-t", "x", "--out_dir", str(tmp_path)]
                               + TINY + flags)
        plan = mesh_plan(a.mesh, a.device, a.spatial)
        assert (plan.n_local, plan.world, plan.device) == (2, 2, "cpu")
        with pytest.raises(ValueError, match="not with 'dcn'"):
            mesh_plan("dcn", a.device, a.spatial)
        return
    mh = _no_fleet(monkeypatch)
    res = illustrip.run(illustrip.get_args(
        ["-t", "x", "--out_dir", str(tmp_path / "m")] + TINY + flags))
    if flags[0] == "--fleet":
        assert mh.fleet_info() == (0, 2) and res.frames == 3
        return
    dense = illustrip.run(illustrip.get_args(
        ["-t", "x", "--out_dir", str(tmp_path / "d")] + TINY))
    assert res.losses == dense.losses
    assert torch.equal(res.params, dense.params)


def test_entry_point_raises_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        illustrip.main(["-t", "x", "--out_dir", str(tmp_path), "-nv"])
