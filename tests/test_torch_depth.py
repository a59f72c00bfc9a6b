"""The port's depth path (aphantasia_torch/models/depth_anything/,
motion/depthwarp.py, the depth branch of `build_frame_step`, cli/depth.py)
against the JAX package on the CPU, with a tiny Depth-Anything-V2 (4
layers of width 32: the DPT head taps four): the resize helpers, the
DINOv2 features, `dav2_apply`, `InferDepthAny`, the HF checkpoint
converter (on a state dict the test writes), the blur, the grid warp, the
mirror fusion, the depth helpers and the depth frame step; and both depth
CLIs end to end at a tiny size (`--device cpu`)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.models.depth_anything import dinov2 as jdino
from aphantasia_tpu.models.depth_anything import dpt as jdpt
from aphantasia_tpu.models.depth_anything.convert import (
    convert_hf_dav2 as jconvert)
from aphantasia_tpu.motion import depthwarp as jdw
from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.ops import resize as jresize
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.params.fft import FFTParameterizer as JFFT
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import illustrip
from aphantasia_torch.cli.common import build_prompt_groups
from aphantasia_torch.convert import (clip_params_from_numpy,
                                      dav2_params_from_numpy)
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.models.depth_anything import dinov2 as tdino
from aphantasia_torch.models.depth_anything import dpt as tdpt
from aphantasia_torch.models.depth_anything.convert import (
    convert_hf_dav2 as tconvert)
from aphantasia_torch.motion import depthwarp as tdw
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops import resize as tresize
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer

from _torch_parity import jax_step_draws, tree_np

TINY_KW = dict(name="s", dim=32, depth=4, n_heads=2, take_layers=(0, 1, 2, 3),
               out_channels=(8, 12, 16, 20), features=16)
JCFG, TCFG = jdpt.DAV2Config(**TINY_KW), tdpt.DAV2Config(**TINY_KW)


@pytest.fixture(scope="module")
def tiny_dav2():
    """The JAX tiny model's params and the same tree in the port."""
    jp = jdpt.dav2_init(jax.random.PRNGKey(0), JCFG)
    return jp, dav2_params_from_numpy(tree_np(jp))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, tol)


def test_resize_helpers_match_jax():
    """The align_corners bilinear matrix and the half-pixel bicubic resize
    (both ways: the position embeddings shrink and grow)."""
    lin = jax.jit(jresize.linear_axis_matrix, static_argnums=(0, 1))
    for out, inn in ((9, 4), (4, 9), (1, 5), (37, 37)):
        np.testing.assert_allclose(
            tresize.linear_axis_matrix(out, inn).numpy(),
            np.asarray(lin(out, inn)), atol=1e-7)
    x = np.random.RandomState(0).randn(5, 37, 37).astype(np.float32)
    half = jax.jit(jresize.resize_bicubic_halfpix, static_argnums=1)
    for size in ((2, 3), (40, 51)):
        _close(tresize.resize_bicubic_halfpix(torch.tensor(x), size).numpy(),
               half(jnp.asarray(x), size), 1e-5)


def test_dinov2_features_match_jax(tiny_dav2):
    """The four tapped layers (final LayerNorm on each, class token
    stripped) at a 2 x 3 and a 3 x 4 patch grid: within 1e-5 of max."""
    jp, tp = tiny_dav2
    feats = jax.jit(lambda p, x: jdino.dinov2_features(p, x, 2,
                                                       {0, 1, 2, 3}))
    for shape in ((2, 3, 28, 42), (1, 3, 42, 56)):
        x = np.random.RandomState(1).randn(*shape).astype(np.float32)
        want = feats(jp["backbone"], jnp.asarray(x))
        got = tdino.dinov2_features(tp["backbone"], torch.tensor(x), 2,
                                    {0, 1, 2, 3})
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-5)


def test_dav2_apply_and_infer_match_jax(tiny_dav2):
    """The raw depth of `dav2_apply` (a 3 x 4 patch grid: odd and even, so
    the down convolution's padding shows) and `InferDepthAny`'s min-maxed
    depth: within 1e-4 of max."""
    jp, tp = tiny_dav2
    shape = (2, 3, 42, 56)                  # a 3 x 4 patch grid
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    both = jax.jit(lambda p, x: (jdpt.dav2_apply(p, JCFG, x),
                                 jdpt.InferDepthAny.apply(p, JCFG, x)))
    want_raw, want = both(jp, jnp.asarray(x))
    _close(tdpt.dav2_apply(tp, TCFG, torch.tensor(x)).numpy(), want_raw, 1e-4)
    got = tdpt.InferDepthAny.apply(tp, TCFG, torch.tensor(x))
    _close(got.numpy(), want, 1e-4)
    assert got.shape == (shape[0], 1) + shape[2:]
    assert abs(got.min().item()) < 1e-6 and abs(got.max().item() - 1) < 1e-5


def _hf_state_dict(seed=3, d=32, layers=4, oc=(8, 12, 16, 20), f=16, g0=2):
    """A random state dict in the HF `DepthAnythingForDepthEstimation`
    naming and layouts."""
    rs = np.random.RandomState(seed)

    def r(*shape):
        return torch.tensor(0.2 * rs.randn(*shape).astype(np.float32))
    sd = {"backbone.embeddings.cls_token": r(1, 1, d),
          "backbone.embeddings.position_embeddings": r(1, 1 + g0 * g0, d),
          "backbone.embeddings.patch_embeddings.projection.weight":
              r(d, 3, 14, 14),
          "backbone.embeddings.patch_embeddings.projection.bias": r(d),
          "backbone.layernorm.weight": 1 + r(d),
          "backbone.layernorm.bias": r(d)}
    for i in range(layers):
        p = f"backbone.encoder.layer.{i}."
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + r(d), r(d)
        for n in ("query", "key", "value"):
            sd[p + f"attention.attention.{n}.weight"] = r(d, d)
            sd[p + f"attention.attention.{n}.bias"] = r(d)
        sd[p + "attention.output.dense.weight"] = r(d, d)
        sd[p + "attention.output.dense.bias"] = r(d)
        sd[p + "layer_scale1.lambda1"] = r(d)
        sd[p + "layer_scale2.lambda1"] = r(d)
        sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = r(4 * d, d), r(4 * d)
        sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = r(d, 4 * d), r(d)
    rsl = "neck.reassemble_stage.layers."
    for i in range(4):
        sd[f"{rsl}{i}.projection.weight"] = r(oc[i], d, 1, 1)
        sd[f"{rsl}{i}.projection.bias"] = r(oc[i])
        sd[f"neck.convs.{i}.weight"] = r(f, oc[i], 3, 3)
        p = f"neck.fusion_stage.layers.{i}."
        for j in (1, 2):
            for c in (1, 2):
                sd[p + f"residual_layer{j}.convolution{c}.weight"] = r(f, f, 3, 3)
                sd[p + f"residual_layer{j}.convolution{c}.bias"] = r(f)
        sd[p + "projection.weight"], sd[p + "projection.bias"] = r(f, f, 1, 1), r(f)
    sd[rsl + "0.resize.weight"], sd[rsl + "0.resize.bias"] = r(oc[0], oc[0], 4, 4), r(oc[0])
    sd[rsl + "1.resize.weight"], sd[rsl + "1.resize.bias"] = r(oc[1], oc[1], 2, 2), r(oc[1])
    sd[rsl + "3.resize.weight"], sd[rsl + "3.resize.bias"] = r(oc[3], oc[3], 3, 3), r(oc[3])
    sd["head.conv1.weight"], sd["head.conv1.bias"] = r(f // 2, f, 3, 3), r(f // 2)
    sd["head.conv2.weight"], sd["head.conv2.bias"] = r(32, f // 2, 3, 3), r(32)
    sd["head.conv3.weight"], sd["head.conv3.bias"] = r(1, 32, 1, 1), r(1)
    return sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_convert_hf_dav2_matches_jax(tmp_path):
    """A state dict written here, as a `torch.save` file and as an HF
    directory (pytorch_model.bin), converts to the JAX converter's tree
    (through `dav2_params_from_numpy`) leaf for leaf, and the converted
    model gives JAX's depth within 1e-4 of max."""
    sd = _hf_state_dict()
    path = str(tmp_path / "dav2.pt")
    torch.save(sd, path)
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    torch.save(sd, str(hf_dir / "pytorch_model.bin"))
    jtree = jconvert(path)
    want = dict(_leaves(dav2_params_from_numpy(tree_np(jtree))))
    for src in (path, str(hf_dir), sd):
        got = dict(_leaves(tconvert(src)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
    x = np.random.RandomState(4).rand(1, 3, 42, 56).astype(np.float32)
    _close(tdpt.dav2_apply(tconvert(sd), TCFG, torch.tensor(x)).numpy(),
           jax.jit(lambda p, v: jdpt.dav2_apply(p, JCFG, v))(
               jtree, jnp.asarray(x)), 1e-4)


def test_blur_grid_warp_and_dims_match_jax():
    rs = np.random.RandomState(5)
    x = rs.rand(1, 3, 20, 26).astype(np.float32)
    jx = jnp.asarray(x)
    _close(tdw.triangle_blur(torch.tensor(x), 5, 2.0).numpy(),
           jax.jit(lambda v: jdw.triangle_blur(v, 5, 2.0))(jx), 1e-6)
    depth = rs.rand(1, 20, 26).astype(np.float32)
    warp = jax.jit(jdw.grid_warp, static_argnums=2)
    for strength, centre, mid in ((0.0, (0.0, 0.0), 0.5),
                                  (0.3, (0.2, -0.4), 0.6),
                                  (1.5, (-0.9, 0.7), 1.1)):
        got = tdw.grid_warp(torch.tensor(x), torch.tensor(depth), strength,
                            centre, mid)
        want = warp(jx, jnp.asarray(depth), strength,
                    jnp.asarray(centre, jnp.float32), mid)
        _close(got.numpy(), want, 1e-5)
    for size in ((720, 1280), (48, 48), (1280, 720), (30, 45)):
        assert tdw.depth_dims(size) == jdw.depth_dims(size)
    np.testing.assert_allclose(
        tdw.depth_preview(torch.tensor(x), (20, 26)).numpy(),
        np.asarray(jax.jit(lambda v: jdw.depth_preview(v, (20, 26)))(jx)),
        atol=1e-5)


def test_mirror_fusion_and_depth_transform_match_jax(tiny_dav2):
    """`mirror_fused_depth` through `InferDepthAny`, and the whole
    `depth_transform` of a frame state (its preview at the DA-V2 size,
    the fused depth, the two warps)."""
    jp, tp = tiny_dav2
    jinf = jdpt.InferDepthAny("s", params=jp)
    tinf = tdpt.InferDepthAny("s", params=tp)
    tinf.cfg = TCFG
    jinf.cfg = JCFG
    rs = np.random.RandomState(6)
    prev = rs.rand(1, 3, 28, 42).astype(np.float32)
    got = tdw.mirror_fused_depth(tinf, torch.tensor(prev))
    want = jdw.mirror_fused_depth(jinf, jnp.asarray(prev))
    assert got.shape == (1, 1, 28, 42)
    _close(got.numpy(), want, 1e-4)
    img_t = rs.randn(1, 3, 16, 16).astype(np.float32)
    got = tdw.depth_transform(torch.tensor(img_t), tinf, 0.4, 1.013,
                              (3.0, -2.0), colors=2.3)
    want = jdw.depth_transform(jnp.asarray(img_t), jinf, 0.4, 1.013,
                               (3.0, -2.0), colors=2.3)
    _close(got.numpy(), want, 1e-4)


def test_depth_frame_step_matches_jax(tiny_dav2):
    """The depth helpers (the first preview, the mirror-fused DA-V2
    forward) and two FFT frames of the depth frame step (opt_steps 2,
    --depth 1) against JAX's `build_depth_helpers` and `build_frame_step`
    on JAX's draws and JAX's depth maps: the preview and depth within
    1e-4 of max, then the frame step's tolerances of
    tests/test_torch_illustrip.py (losses 2e-4 relative, the frame within
    1 grey level, params rtol 6e-3 / atol 2.5e-2), each frame's preview
    within 1e-3 of max."""
    jp, tp = tiny_dav2
    jinf = jdpt.InferDepthAny("s", params=jp)
    tinf = tdpt.InferDepthAny("s", params=tp)
    jinf.cfg, tinf.cfg = JCFG, TCFG
    h, w, s, lr = 24, 32, 3, 0.05
    ccfg = dict(name="tiny", embed_dim=32, image_resolution=32,
                vision_layers=2, vision_width=128, vision_patch_size=8,
                transformer_width=64, transformer_heads=2,
                transformer_layers=2)
    jcfg, tcfg = jm.CLIPConfig(**ccfg), tm.CLIPConfig(**ccfg)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    tclip = clip_params_from_numpy(tree_np(jclip))
    rs = np.random.RandomState(7)
    p0 = (0.01 * rs.randn(1, 3, h, w // 2 + 1, 2)).astype(np.float32)
    emb = rs.randn(1, 32).astype(np.float32)
    kw = dict(sim="mix", noise=2.0, noise_centered=True, total_steps=2,
              transform="none")
    jset = jstep.StepSettings(clip_dtype=jnp.float32, **kw)
    tset = tstep.StepSettings(clip_dtype=torch.float32, **kw)
    jsam = JSampler((h, w), s, 32, "overscan", 0.3)
    tsam = CutoutSampler((h, w), s, 32, "overscan", 0.3)
    jopt = jo.build_optimizer("adam_custom", lr)
    topt = to.build_optimizer("adam_custom", lr)
    jfs = jstep.build_frame_step(JFFT((h, w), 1.0, 2.3), jsam, jcfg, jset,
                                 jopt, "FFT", (h, w), 2, False, contrast=1.2,
                                 deptha=jinf, depth=1.0, colors=2.3)
    tfs = tstep.build_frame_step(FFTParameterizer((h, w), 1.0, 2.3), tsam,
                                 tcfg, tset, topt, "FFT", (h, w), 2, False,
                                 contrast=1.2, deptha=tinf, depth=1.0,
                                 colors=2.3)
    jprev_fn, jinfer = jstep.build_depth_helpers("FFT", (h, w), jinf, 2.3)
    thelp = tstep.build_depth_helpers("FFT", (h, w), tinf, 2.3)
    jpreview = jprev_fn(jnp.asarray(p0))
    tpreview = thelp.preview(torch.tensor(p0))
    _close(tpreview.numpy(), jpreview, 1e-4)
    jdmap = jinfer(jpreview)
    _close(thelp.infer(torch.tensor(np.asarray(jpreview))).numpy(), jdmap,
           1e-4)
    jpar, tpar = jnp.asarray(p0), torch.tensor(p0)
    js, ts = jopt.init(jpar), topt.init(tpar)
    jpe, tpe = jnp.zeros((s, 32)), torch.zeros((s, 32))
    key = jax.random.PRNGKey(8)
    jprompts = ((jnp.asarray(emb), jnp.ones((1,)), jnp.float32(-1.0)),)
    for ii, motion in enumerate([(2.0, 4.0, -3.0, 1.03, 0.4),
                                 (-1.0, -2.0, 1.0, 0.98, -0.2)]):
        k = jax.random.fold_in(key, ii)
        dmap = np.asarray(jdmap)
        jpar, js, jpe, jframe, jl, jpv = jfs(
            jpar, js, jpe, jclip, None, jprompts, k, jnp.int32(ii),
            tuple(jnp.float32(v) for v in motion), jnp.asarray(dmap))
        tpar, ts, tpe, tframe, tl, tpv = tfs(
            tpar, ts, tpe, tclip, None, build_prompt_groups(
                [(torch.tensor(emb), torch.ones(1), -1.0)]),
            [jax_step_draws(jax.random.fold_in(k, j), jsam, jset, p0.shape)
             for j in range(2)], ii, motion, torch.tensor(dmap))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=1e-6)
        fd = np.abs(tframe.numpy().astype(int) - np.asarray(jframe).astype(int))
        assert fd.max() <= 1
        np.testing.assert_allclose(tpar.numpy(), np.asarray(jpar), rtol=6e-3,
                                   atol=2.5e-2)
        assert tpv.shape == (1, 3, 518, 686)
        _close(tpv.numpy(), jpv, 1e-3)
        jdmap = jinfer(jpv)


@pytest.fixture
def tiny_models(monkeypatch):
    """Tiny CLIP towers and the tiny model as both packages' DA-V2 's'."""
    monkeypatch.setitem(tm.CLIP_CONFIGS, "ViT-B/32", tm.CLIPConfig(
        name="ViT-B/32", embed_dim=512, image_resolution=224,
        vision_layers=1, vision_width=64, vision_patch_size=32,
        transformer_width=64, transformer_heads=1, transformer_layers=1))
    monkeypatch.setitem(tdpt.DAV2_CONFIGS, "s", TCFG)
    monkeypatch.setitem(jdpt.DAV2_CONFIGS, "s", JCFG)


def test_illustrip_depth_cpu(tmp_path, tiny_models):
    """`illustrip --depth 1 --depth_model s --depth_dir` on two frames: a
    frame and a depth-map JPEG at the frame's size each."""
    from PIL import Image
    ddir = str(tmp_path / "dmaps")
    res = illustrip.run(illustrip.get_args(
        ["-t", "deep", "--size", "32-24", "--steps", "2", "--samples", "2",
         "--out_dir", str(tmp_path / "o"), "-nv", "--transform", "none",
         "--depth", "1.0", "--depth_model", "s", "--fstep", "2",
         "--depth_dir", ddir, "--device", "cpu"]))
    assert sorted(os.listdir(ddir)) == ["00000.jpg", "00001.jpg"]
    with Image.open(os.path.join(ddir, "00001.jpg")) as im:
        assert im.size == (32, 24)
    assert sorted(os.listdir(os.path.join(res.workdir, "ttt"))) == [
        "000000.jpg", "000001.jpg"]
    assert res.depth is not None
    assert all(np.isfinite(x).all() for x in res.losses)


def test_depth_cli_matches_jax(tmp_path, tiny_models, monkeypatch):
    """Both depth CLIs on three images of two sizes (two shape groups) from
    one checkpoint (APHANTASIA_DAV2_PT): one PNG an image at its own size,
    and the port's within 1 grey level of the JAX CLI's."""
    from PIL import Image
    from aphantasia_tpu.cli import depth as jdepth
    from aphantasia_torch.cli import depth as tdepth
    ck = str(tmp_path / "dav2.pt")
    torch.save(_hf_state_dict(g0=37), ck)
    monkeypatch.setenv("APHANTASIA_DAV2_PT", ck)
    monkeypatch.setattr(jdepth, "apply_platform", lambda: None)
    src = tmp_path / "imgs"
    src.mkdir()
    rs = np.random.RandomState(9)
    for name, (hh, ww) in (("a", (30, 45)), ("b", (40, 40)), ("c", (30, 45))):
        Image.fromarray((rs.rand(hh, ww, 3) * 255).astype(np.uint8)).save(
            str(src / f"{name}.png"))
    argv = ["-i", str(src), "--encoder", "vits", "-sz", "28"]
    jdepth.main(argv + ["-o", str(tmp_path / "j")])
    assert tdepth.main(argv + ["-o", str(tmp_path / "t"), "--device",
                               "cpu"]) == 3
    for name in ("a", "b", "c"):
        with Image.open(str(tmp_path / "t" / f"{name}.png")) as im:
            got = np.asarray(im).astype(int)
        with Image.open(str(tmp_path / "j" / f"{name}.png")) as im:
            want = np.asarray(im).astype(int)
        assert got.shape == want.shape == ((30, 45, 3) if name != "b"
                                           else (40, 40, 3))
        assert np.abs(got - want).max() <= 1


def test_depth_cli_raises_without_gpu(tmp_path, monkeypatch):
    from aphantasia_torch.cli import depth as tdepth
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdepth.main(["-i", str(tmp_path), "-o", str(tmp_path)])
