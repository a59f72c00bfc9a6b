"""The port's coordinate nets and cppn CLI (aphantasia_torch/params/cppn.py,
params/siren.py, shader_expo.py, cli/cppn.py and the frame loop's
`with_params`) against the JAX package on the CPU: the decodes of the
three CPPN activations and of SIREN (forward and gradient), the key-wise
conversion of the params and of optax's Adam moments, `.npy` snapshots
across the two packages, the five shader files byte for byte, a cppn step
and a `with_params` frame loop on JAX's draws, and the CLI end to end
(`--device cpu`) with JAX's file names.

Float32.  Tolerances are stated at each test; the SIREN one is derived in
its test from the float64 decode."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.params import cppn as jcppn
from aphantasia_tpu.params import siren as jsiren
from aphantasia_tpu.parallel import step as jstep
from aphantasia_tpu import shader_expo as jshader
from aphantasia_torch import shader_expo as tshader
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import cppn as tcli
from aphantasia_torch.cli.common import build_prompt_groups
from aphantasia_torch.convert import (clip_params_from_numpy,
                                      coord_params_from_numpy,
                                      opt_state_from_optax)
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params import cppn as tcppn
from aphantasia_torch.params import siren as tsiren

from _torch_parity import jax_step_draws, tree_np

SIZE = (12, 20)          # not square: the grid's layout shows
CFG_KW = dict(name="tiny", embed_dim=32, image_resolution=32,
              vision_layers=2, vision_width=128, vision_patch_size=8,
              transformer_width=64, transformer_heads=2, transformer_layers=2)
TINY_B32 = dict(name="ViT-B/32", embed_dim=512, image_resolution=224,
                vision_layers=1, vision_width=64, vision_patch_size=32,
                transformer_width=64, transformer_heads=1,
                transformer_layers=1)
TINY_B16 = dict(TINY_B32, name="ViT-B/16", vision_patch_size=16)
TINY = ["--size", "40-32", "--samples", "2", "-l", "3", "-nf", "8",
        "--device", "cpu"]


def _pars(kind, size=SIZE):
    """(JAX parameterizer, port parameterizer, JAX params) of a small net."""
    if kind == "siren":
        j = jsiren.SIRENParameterizer(size, 16, 3)
        t = tsiren.SIRENParameterizer(size, 16, 3)
    else:
        j = jcppn.CPPNParameterizer(size, 8, 3, kind)
        t = tcppn.CPPNParameterizer(size, 8, 3, kind)
    return j, t, j.init(jax.random.PRNGKey(1))


def _decode64(params, kind, size):
    """The decode in float64 numpy, from the same layers."""
    h, w = size
    x = jcppn.get_mgrid(w, h)[0].reshape(2, -1).T.astype(np.float64)
    n = len(params)
    for i, p in enumerate(params):
        x = x @ np.asarray(p["w"], np.float64) + np.asarray(p["b"], np.float64)
        if i == n - 1:
            x = 1.0 / (1.0 + np.exp(-x))
        elif kind == "siren":
            x = np.sin(30.0 * x)
        elif kind == "relu":
            x = (np.maximum(x, 0) - 0.40) / 0.58
        else:
            a = np.arctan(x)
            b = (a * a) / 0.6 if kind == "comp" else (a * a - 0.45) / 0.396
            x = np.concatenate([a / 0.67, b], -1)
    return x.T.reshape(1, 3, h, w)


@pytest.mark.parametrize("kind", ["unbias", "comp", "relu", "siren"])
def test_decode_and_gradient_match_jax(kind):
    """The decode and the gradient of sum(decode * r) for a fixed random r,
    each param in the port's flat order against JAX's by key.  CPPN:
    forward within 2e-6 absolute, gradient within 1e-5 relative L2.
    SIREN's sin(30 x) multiplies a float32 rounding of its argument by up
    to 30 a layer, so it is held to what float32 can give: the port and
    JAX each within 4x the larger of their own distances to the float64
    decode (and that distance below 1e-4), the gradient within 1e-4
    relative L2."""
    jpar, tpar, jp = _pars(kind)
    tp = coord_params_from_numpy(tree_np(jp))
    r = np.random.RandomState(2).randn(1, 3, *SIZE).astype(np.float32)
    want = np.asarray(jpar.decode(jp))
    xs = [p.clone().requires_grad_(True) for p in tp]
    got_t = tpar.decode(xs)
    got = got_t.detach().numpy()
    assert got.shape == want.shape == (1, 3) + SIZE
    if kind == "siren":
        ref = _decode64(tree_np(jp), kind, SIZE)
        e_j, e_t = np.abs(want - ref).max(), np.abs(got - ref).max()
        assert max(e_j, e_t) < 1e-4, (e_j, e_t)
        assert np.abs(got - want).max() <= 4 * max(e_j, e_t, 1e-7)
        gtol = 1e-4
    else:
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        gtol = 1e-5
    jg = jax.grad(lambda p: jnp.sum(jpar.decode(p) * r))(jp)
    tg = torch.autograd.grad((got_t * torch.tensor(r)).sum(), xs)
    want_g = np.concatenate([np.asarray(layer[k]).ravel()
                             for layer in jg for k in ("w", "b")])
    got_g = np.concatenate([g.numpy().ravel() for g in tg])
    assert np.linalg.norm(got_g - want_g) <= gtol * np.linalg.norm(want_g)


def test_params_and_adam_moments_convert_by_key():
    """`jax.tree_util` flattens each layer's {"w", "b"} as (b, w); the
    converter reads by key, for the params and for optax's Adam moments
    after a step (so mu and nu are not zero)."""
    _, _, jp = _pars("unbias")
    leaves = jax.tree_util.tree_leaves(jp)
    assert leaves[0].shape == (8,) and leaves[1].shape == (2, 8)  # b first
    tp = coord_params_from_numpy(tree_np(jp))
    assert [tuple(p.shape) for p in tp] == [(2, 8), (8,), (16, 8), (8,),
                                           (16, 8), (8,), (16, 3), (3,)]
    for i, layer in enumerate(jp):
        np.testing.assert_array_equal(tp[2 * i].numpy(), layer["w"])
        np.testing.assert_array_equal(tp[2 * i + 1].numpy(), layer["b"])
    opt = optax.adam(0.01)
    st = opt.init(jp)
    grads = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.1, jp)
    _, st = opt.update(grads, st, jp)
    ts = opt_state_from_optax(tree_np(st))
    assert int(ts.count) == 1 and len(ts.mu) == len(ts.nu) == 8
    for i, (m, v) in enumerate(zip(st[0].mu, st[0].nu)):
        for j, k in enumerate(("w", "b")):
            np.testing.assert_array_equal(ts.mu[2 * i + j].numpy(), m[k])
            np.testing.assert_array_equal(ts.nu[2 * i + j].numpy(), v[k])


@pytest.mark.parametrize("kind", ["unbias", "relu", "siren"])
def test_npy_snapshots_cross_the_packages(tmp_path, kind):
    """A snapshot written by either package reads back equal in the other,
    with the architecture inferred (relu from its undoubled widths)."""
    _, _, jp = _pars(kind)
    tp = coord_params_from_numpy(tree_np(jp))
    jcppn.export_npy(jp, str(tmp_path / "j"))
    tcppn.export_npy(tp, str(tmp_path / "t"))
    for path in (tmp_path / "j.npy", tmp_path / "t.npy"):
        if kind == "siren":
            jl, jnf, jn = jsiren.load_npy(str(path))
            tl, tnf, tn = tsiren.load_npy(str(path))
            assert (jnf, jn) == (tnf, tn) == (16, 3)
        else:
            jl, jnf, jn, ja = jcppn.load_npy(str(path))
            tl, tnf, tn, ta = tcppn.load_npy(str(path))
            assert (jnf, jn, ja) == (tnf, tn, ta) == (
                8, 3, "relu" if kind == "relu" else "unbias")
        for got, want in zip(tl, coord_params_from_numpy(tree_np(jl))):
            np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["unbias", "siren"])
def test_shader_files_equal_jax_byte_for_byte(tmp_path, kind):
    """The five targets of `export_all` from each package's own layers."""
    _, _, jp = _pars(kind)
    tp = coord_params_from_numpy(tree_np(jp))
    if kind == "siren":
        jl = jsiren.to_shader_layers(jp, 30.0, 25.0)
        tl = tsiren.to_shader_layers(tp, 30.0, 25.0)
    else:
        jl = jcppn.to_shader_layers(jp, kind)
        tl = tcppn.to_shader_layers(tp, kind)
    jpaths = jshader.export_all(jl, str(tmp_path / "j"), SIZE, 4)
    tpaths = tshader.export_all(tl, str(tmp_path / "t"), SIZE, 4)
    assert [os.path.basename(p)[1:] for p in jpaths] == [
        os.path.basename(p)[1:] for p in tpaths] == [
        "-td.glsl", ".tfx", ".txt", "-bookofshaders.glsl",
        "-shadertoy.glsl"]
    for a, b in zip(jpaths, tpaths):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def _step_setup(h=32, w=40, s=3):
    jcfg, tcfg = jm.CLIPConfig(**CFG_KW), tm.CLIPConfig(**CFG_KW)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    emb = np.random.RandomState(4).randn(2, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    kw = dict(sim="cossim", sharp=0.3, sharp_mode="sobel", transform="none",
              total_steps=4)
    jpar, tpar, jp = _pars("unbias", (h, w))
    return dict(
        jcfg=jcfg, tcfg=tcfg, jclip=jclip,
        tclip=clip_params_from_numpy(tree_np(jclip)), jp=jp,
        tp=coord_params_from_numpy(tree_np(jp)), jpar=jpar, tpar=tpar,
        jset=jstep.StepSettings(clip_dtype=jnp.float32, **kw),
        tset=tstep.StepSettings(clip_dtype=torch.float32, **kw),
        jsam=JSampler((h, w), s, 32, "overscan", 0.4),
        tsam=CutoutSampler((h, w), s, 32, "overscan", 0.4),
        jprompts=((jnp.asarray(emb), jnp.asarray(wts), jnp.float32(-1.0)),
                  (jnp.asarray(emb[:1]), jnp.asarray(wts[:1]),
                   jnp.float32(0.5))),
        tprompts=build_prompt_groups([
            (torch.tensor(emb), torch.tensor(wts), -1.0),
            (torch.tensor(emb[:1]), torch.tensor(wts[:1]), 0.5)]))


LR = 0.003


def _close(jp, tp, jl, tl):
    """Losses within 1e-4 relative; params within 2e-3 of the learning rate
    in the mean and 5e-2 of it at the worst element (the envelope of
    tests/test_torch_loop.py)."""
    np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-6)
    want = coord_params_from_numpy(tree_np(jp))
    err = np.concatenate([np.abs(a.numpy() - b.numpy()).ravel()
                          for a, b in zip(tp, want)])
    assert err.mean() <= 2e-3 * LR and err.max() <= 5e-2 * LR, (
        err.mean(), err.max())


def test_cppn_steps_match_jax():
    """Three cppn steps (optax.adam with b1 = 0.9, cossim, sobel sharpness
    0.3, a text and a subtract group) on JAX's draws."""
    c = _step_setup()
    jopt, topt = optax.adam(LR), to.build_optimizer("adam", LR)
    jtrain = jstep.build_train_step(c["jpar"], c["jsam"], c["jcfg"],
                                    c["jset"], jopt)
    ttrain = tstep.build_train_step(c["tpar"], c["tsam"], c["tcfg"],
                                    c["tset"], topt)
    jp, tp = c["jp"], c["tp"]
    js, ts = jopt.init(jp), topt.init(tp)
    jprev, tprev = jnp.zeros((3, 32)), torch.zeros((3, 32))
    key = jax.random.PRNGKey(5)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        jp, js, jprev, jl = jtrain(jp, js, jprev, c["jclip"], None, None,
                                   c["jprompts"], k, jnp.int32(i))
        tp, ts, tprev, tl = ttrain(
            tp, ts, tprev, c["tclip"], None, None, c["tprompts"],
            jax_step_draws(k, c["jsam"], c["jset"], None), i)
        _close(jp, tp, [float(jl)], [tl.item()])
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), atol=1e-4)


def test_frame_loop_with_params_matches_jax():
    """`build_train_loop_frames(with_params=True)` at opt_step 2, two frame
    groups a call, two calls, the global step index: frames within one
    level, each group's snapshot against JAX's (the params at the render
    point, after the group's first step: not the group's end), losses and
    final params as `_close`."""
    c = _step_setup()
    opt_step, nf = 2, 2
    jopt, topt = optax.adam(LR), to.build_optimizer("adam", LR)
    jloop = jstep.build_train_loop_frames(
        c["jpar"], c["jsam"], c["jcfg"], c["jset"], jopt, opt_step, nf,
        step_index="step", with_params=True)
    tloop = tstep.build_train_loop_frames(
        c["tpar"], c["tsam"], c["tcfg"], c["tset"], topt, opt_step, nf,
        step_index="step", with_params=True)
    jstate = (c["jp"], jopt.init(c["jp"]), jnp.zeros((3, 32)))
    tstate = (c["tp"], topt.init(c["tp"]), torch.zeros((3, 32)))
    key = jax.random.PRNGKey(6)

    def draws(gstep):
        return jax_step_draws(jax.random.fold_in(key, gstep), c["jsam"],
                              c["jset"], None)
    for call in range(2):
        *jstate, jframes, jsnap, jl = jloop(*jstate, c["jclip"], None, None,
                                            c["jprompts"], key,
                                            jnp.int32(call * nf))
        *tstate, tframes, tsnap, tl = tloop(*tstate, c["tclip"], None, None,
                                            c["tprompts"], draws, call * nf)
        assert tframes.shape == (nf, 32, 40, 3) and len(tsnap) == 8
        assert all(s.shape[0] == nf for s in tsnap)
        fd = np.abs(tframes.numpy().astype(int) - np.asarray(jframes))
        assert fd.max() <= 1
        for j in range(nf):
            _close([{k: v[j] for k, v in layer.items()} for layer in jsnap],
                   [s[j] for s in tsnap], [], [])
        _close(jstate[0], tstate[0], jl, tl)
        # the render point is not the group's end
        assert not torch.equal(tsnap[0][nf - 1], tstate[0][0])
    assert int(tstate[1].count) == 2 * opt_step * nf


@pytest.fixture
def tiny_towers(monkeypatch):
    for kw in (TINY_B32, TINY_B16):
        monkeypatch.setitem(tm.CLIP_CONFIGS, kw["name"], tm.CLIPConfig(**kw))
        monkeypatch.setitem(jm.CLIP_CONFIGS, kw["name"], jm.CLIPConfig(**kw))


def _listing(root):
    return {os.path.relpath(os.path.join(dp, f), root)
            for dp, _, fs in os.walk(root) for f in fs}


def test_cli_outputs_and_names_equal_jax(tmp_path, monkeypatch, tiny_towers):
    """The JAX CLI and the port's on the same flags (two text prompts, 4
    steps, --fstep 2): the same files (frames and snapshots a saved step,
    the final `.npy`, five shaders, the video and the last frame), and
    the port's snapshots readable by the JAX package."""
    from aphantasia_tpu.cli import cppn as jcli
    from aphantasia_tpu.parallel import multihost
    monkeypatch.setattr(jcli, "apply_platform", lambda: None)
    monkeypatch.setattr(multihost, "init_fleet", lambda spec=None: (0, 1))
    argv = ["-t", "a test", "-t0", "not this", "--steps", "4", "--fstep",
            "2"] + TINY[:-2]
    jcli.main(argv + ["--out_dir", str(tmp_path / "j")])
    res = tcli.run(tcli.get_args(argv + ["--out_dir", str(tmp_path / "t"),
                                        "--device", "cpu"]))
    got = _listing(tmp_path / "t")
    assert got == _listing(tmp_path / "j")
    assert got == {os.path.join("cppn", f) for f in (
        "a_test-l3-n8/0000.jpg", "a_test-l3-n8/0000.npy",
        "a_test-l3-n8/0001.jpg", "a_test-l3-n8/0001.npy", "a_test-l3-n8.npy",
        "a_test-l3-n8-td.glsl", "a_test-l3-n8.tfx", "a_test-l3-n8.txt",
        "a_test-l3-n8-bookofshaders.glsl", "a_test-l3-n8-shadertoy.glsl",
        "a_test-l3-n8.avi", "a_test-l3-n8-4.jpg")}
    assert res.samples == 2 and len(res.losses) == 4
    assert all(np.isfinite(res.losses)) and res.loop is not None
    jl, nf, n, act = jcppn.load_npy(res.out_base + ".npy")
    assert (nf, n, act) == (8, 3, "unbias")
    np.testing.assert_array_equal(np.asarray(jl[-1]["w"]),
                                  res.params[-2].numpy())


@pytest.mark.parametrize("flags,name,samples,chunked", [
    (["--gen", "siren", "--steps", "2"], "x-l3-n8-siren", 2, True),
    (["--dualmod", "2", "--steps", "4", "--fstep", "2"], "x-l3-n8-dm2", 1,
     True),
    (["--steps", "3", "--fstep", "2"], "x-l3-n8", 2, False),
    (["-tf", "--pallas", "--samples", "3", "--steps", "2"], "x-l3-n8", 2,
     True)])
def test_cli_paths(tmp_path, tiny_towers, flags, name, samples, chunked):
    """SIREN, --dualmod 2 (ViT-B/16 on step 2, budget x0.69), the per-step
    loop (--fstep 2 does not divide 3 steps: frames at steps 0 and 2) and
    -tf with --pallas (budget x0.95)."""
    out = tmp_path / "o"
    res = tcli.run(tcli.get_args(["-t", "x", "--out_dir", str(out)] + TINY
                                 + flags))
    run_dir = out / "cppn" / name
    assert os.path.basename(res.out_base) == name
    files = sorted(os.listdir(run_dir))
    assert files == sorted(["%04d.%s" % (i, e) for i in range(2)
                            for e in ("jpg", "npy")])
    assert all(np.isfinite(res.losses))
    assert (res.loop is not None) == chunked and res.samples == samples
    if chunked and "--dualmod" in flags:
        assert sorted(res.loop.groups) == [(0, 0), (1, 0)]
    if "siren" in flags:
        _, nf, n = tsiren.load_npy(res.out_base + ".npy")
        assert (nf, n) == (8, 3)
        assert "sin(" in open(res.out_base + "-shadertoy.glsl").read()


def test_export_writes_shaders_and_image(tmp_path):
    """--export -r net.npy: the five shaders and the image beside the
    snapshot, the net read as written, no training."""
    _, tpar, jp = _pars("comp", (24, 24))
    path = str(tmp_path / "net.npy")
    jcppn.export_npy(jp, path)
    assert tcli.run(tcli.get_args(["-r", path, "--export", "--size",
                                   "24-24", "--device", "cpu"])) is None
    files = set(os.listdir(tmp_path))
    assert {"net.jpg", "net-td.glsl", "net.tfx", "net.txt",
            "net-bookofshaders.glsl", "net-shadertoy.glsl"} <= files
    from PIL import Image
    with Image.open(tmp_path / "net.jpg") as im:
        assert im.size == (24, 24)


@pytest.mark.parametrize("flags", [["--mesh", "2"], ["--fleet", "0/2"]])
def test_unported_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
        tcli.run(tcli.get_args(["-t", "x", "--out_dir", str(tmp_path)]
                               + TINY + flags))
