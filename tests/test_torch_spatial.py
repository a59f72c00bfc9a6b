"""The port's spatially sharded canvases (aphantasia_torch/parallel/
spatial.py, spatial_dwt.py, the spatial DCN witness and --spatial in the
CLIs) against the JAX package on the CPU: gloo ranks spawned by the
port's launcher (workers in tests/_torch_dist.py) against JAX's spatial
functions on the conftest's 8 virtual CPU devices, from the same
canonical params, boxes, draws and converted weights (a tiny CLIP).

The spawns run on a background thread while this one compiles the JAX
references: 2 ranks (the FFT cut at S = 2, the DWT with k_fine >= 1,
both frame warps and the depth preview, the chunked loop with `dual=`),
4 ranks (the cut at S = 4, RGB with H % S != 0, every term of the step
at data 2 x spatial 2, the DCN witness on JAX's inputs) and 8 ranks (the
three spatial layouts of MULTICHIP_r05.json).

Tolerances (float32):
* cuts, renders, warps, previews and gradients: max |port - JAX| within
  2e-4 of max |JAX| (tests/test_spatial.py's 2e-4 for cuts; its
  gradient bound, 2e-4 absolute and 2e-3 relative, is looser);
  sharpness and anchors 1e-5 relative;
* train steps, the loop and the frame steps: losses 1e-4 relative, the
  encodings within 1e-3 of max |JAX|; the params within 2e-3 of the
  learning rate in the mean, with at most one element in a thousand off
  by more than 1e-2 of it (test_torch_dcn.py's: adam_custom moves an
  element by its gradient over the root of its mean square, so an
  element whose gradients are near zero turns a float32 difference into
  a large step); frames within one level;
* pads: exactly zero, in every gradient and after every step;
* the DCN witness: the port's layouts agree to 1e-6 relative; against
  JAX (the `fast` pipeline warps in bf16) the loss within 2.5e-4
  absolute (a loss of -0.034 here: 2e-3 relative of the dense witness's
  larger loss) and the digest within 1e-3 relative (test_torch_dcn.py's);
* the CLIs at --spatial 2: losses within 1e-4 relative of the dense run
  (the same draws: no noise), the `.pt` in the reference layout."""
import concurrent.futures
import functools
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.parallel import spatial as jsp
from aphantasia_tpu.parallel.mesh import make_mesh_spatial as jmesh
from aphantasia_tpu.parallel.spatial_dwt import SpatialDWT as JDWT
from aphantasia_tpu.parallel.step import StepSettings as JSettings
from aphantasia_tpu.params.dwt import dwt_max_level, dwt_shapes
from aphantasia_torch.parallel.mesh import Plan, free_port, spawn

from _torch_parity import jax_step_draws, tree_np
import _torch_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="tiny", embed_dim=32, image_resolution=32, vision_layers=2,
            vision_width=32, vision_patch_size=16, context_length=16,
            vocab_size=256, transformer_width=32, transformer_heads=2,
            transformer_layers=2, vision_heads_override=2)
TINY2 = dict(TINY, name="tiny2")
LR = 0.05
EVERY = dict(sim="mix", transform="none", sharp=0.2, aest=2.0, sync=0.5,
             total_steps=5, enforce=0.3, expand=0.5)


# ------------------------------------------------------------------ inputs

@functools.lru_cache(None)
def _clip(kw_items, seed=0):
    cfg = jm.CLIPConfig(**dict(kw_items))
    return cfg, tree_np(jm.clip_init(jax.random.PRNGKey(seed), cfg))


def _canonical(canvas, size, seed, wave="coif2"):
    rs = np.random.RandomState(seed)
    h, w = size
    if canvas == "fft":
        return (0.07 * rs.randn(1, 3, h, w // 2 + 1, 2)).astype(np.float32)
    if canvas == "rgb":
        return rs.randn(1, 3, h, w).astype(np.float32)
    return [rs.randn(*s).astype(np.float32)
            for s in dwt_shapes(size, wave, dwt_max_level(min(size)))]


def _jcanvas(c, mesh):
    if c["canvas"] == "fft":
        return jsp.SpatialFFT(c["size"], c.get("decay", 1.5), 1.8, mesh)
    if c["canvas"] == "rgb":
        return jsp.SpatialRGB(c["size"], 1.8, mesh)
    return JDWT(c["size"], c.get("wave", "coif2"), 0.3, 1.8, mesh)


def _jmesh(c):
    return jmesh(c["spatial"], c.get("mesh"))


def _unpad(spar, p):
    if isinstance(spar, jsp.SpatialFFT):
        return np.asarray(jsp.unpad_spectrum(p, spar.size[1]))
    out = spar.unpad(p)
    return ([np.asarray(v) for v in out] if isinstance(out, list)
            else np.asarray(out))


def _jsampler(c, count):
    return JSampler(tuple(c["size"]), count, 32, "uniform",
                    c.get("macro", 0.0))


def _padded_shape(c):
    h, w = c["size"]
    n = c["spatial"]
    return (1, 3, h, -(-(w // 2 + 1) // n) * n, 2)


def _cut_case(canvas, size, spatial, seed, sharp=True, anchors=False,
              shift=False, wave="coif2", samples=4):
    c = dict(kind="cut", canvas=canvas, size=size, spatial=spatial,
             wave=wave, macro=0.3, sharp=sharp, anchors=anchors,
             params=_canonical(canvas, size, seed, wave))
    boxes = _jsampler(c, samples).sample_boxes(jax.random.PRNGKey(seed + 1))
    rs = np.random.RandomState(seed + 2)
    c["jboxes"] = boxes
    c["boxes"] = [np.asarray(b) for b in boxes]
    c["co"] = rs.randn(samples, 3, 32, 32).astype(np.float32)
    c["anchor_w"] = rs.randn(2, 3).astype(np.float32)
    if shift:
        c["shift"] = np.asarray(0.2 * jax.random.uniform(
            jax.random.PRNGKey(seed + 3), (1, 1) + _padded_shape(c)[2:4]
            + (1,)))
    return c


def _prompt_inputs(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 32).astype(np.float32),
            np.asarray([1.0, 0.5], np.float32))


def _step_case(kind, canvas, size, spatial, mesh, samples, settings, n,
               seed, wave="coif2", **extra):
    c = dict(kind=kind, canvas=canvas, size=size, spatial=spatial, mesh=mesh,
             wave=wave, samples=samples, settings=settings, lr=LR, cfg=TINY,
             clip=_clip(tuple(TINY.items()))[1], prompts=_prompt_inputs(seed),
             params=_canonical(canvas, size, seed, wave), macro=0.4, **extra)
    jset = JSettings(**settings)
    key = jax.random.PRNGKey(seed + 10)
    c["keys"] = [jax.random.fold_in(key, i) for i in range(n)]
    c["key"] = key
    c["draws"] = [jax_step_draws(k, _jsampler(c, samples), jset,
                                 _padded_shape(c)) for k in c["keys"]]
    if settings.get("sync"):
        from aphantasia_tpu.models.lpips import lpips_init
        rs = np.random.RandomState(seed + 20)
        c["head"] = {"w": (0.1 * rs.randn(32, 1)).astype(np.float32),
                     "b": np.asarray([0.2], np.float32)}
        c["lpips"] = tree_np(lpips_init(jax.random.PRNGKey(1)))
        h, w = size
        c["img_in"] = rs.rand(1, 3, h // 2, w // 2).astype(np.float32)
    return c


MOTION = (2.0, 1.0, -1.0, 1.02, 0.3)


@functools.lru_cache(None)
def _cases():
    """Every spawn's cases, by rank count."""
    dmap = np.random.RandomState(7).rand(1, 1, 28, 42).astype(np.float32)
    warp = dict(kind="warp", spatial=2, motion=MOTION, dmap=dmap, depth=1.0,
                cfg=TINY, settings=dict(transform="none"))
    two = [
        _cut_case("fft", (64, 96), 2, 0, shift=True),
        _cut_case("dwt", (128, 96), 2, 1, sharp=False, wave="db3"),
        dict(warp, canvas="fft", size=(64, 96), params=_canonical(
            "fft", (64, 96), 3)),
        dict(warp, canvas="rgb", size=(51, 96), params=_canonical(
            "rgb", (51, 96), 4)),
        _step_case("loop", "fft", (64, 96), 2, None, 4,
                   dict(sim="cossim", transform="none", noise=0.1,
                        total_steps=4), 4, 5, cfg2=TINY2,
                   clip2=_clip(tuple(TINY2.items()), 99)[1],
                   prompts2=_prompt_inputs(6), dm_every=2),
    ]
    four = [
        _cut_case("fft", (64, 96), 4, 10, shift=True),
        _cut_case("rgb", (50, 96), 4, 11, anchors=True, samples=5),
        _step_case("steps", "fft", (64, 96), 2, "2", 8,
                   dict(EVERY, noise=0.1), 2, 12),
        _step_case("steps", "rgb", (64, 96), 2, "2", 8,
                   dict(EVERY, rgb_anchors=True), 2, 13),
        _step_case("steps", "rgb", (50, 96), 4, None, 4,
                   dict(sim="mix", transform="none", sharp=0.3,
                        rgb_anchors=True, enforce=0.2), 3, 14),
        dict(kind="witness", inputs=_witness_inputs()),
    ]
    frame = dict(motion=MOTION, contrast=1.2)
    eight = [
        _step_case("frame", "fft", (64, 64), 2, "4", 8,
                   dict(sim="mix", transform="none", total_steps=4), 2, 20,
                   decay=1.0, dmap=dmap, **frame),
        _step_case("frame", "fft", (64, 64), 4, "2", 4,
                   dict(sim="mix", transform="none", total_steps=4), 2, 21,
                   decay=1.0, **frame),
        _step_case("steps", "dwt", (64, 64), 2, "4", 8,
                   dict(sim="mix", transform="none", total_steps=4), 2, 22,
                   wave="db2"),
    ]
    return {2: two, 4: four, 8: eight}


def _portable(c):
    return {k: v for k, v in c.items() if k not in ("keys", "key", "jboxes")}


def _run_spawn(n):
    cases = [_portable(c) for c in _cases()[n]]
    return spawn(_torch_dist.spatial_worker, (cases,),
                 Plan(n, f"127.0.0.1:{free_port()}", "cpu"))


@functools.lru_cache(None)
def _spawns():
    """The three spawns, one after the other on a background thread."""
    _cases()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    out = {n: pool.submit(_run_spawn, n) for n in (2, 4, 8)}
    pool.shutdown(wait=False)
    return out


def _ranks(n, i):
    """Case i of the n-rank spawn, on every rank."""
    return [r[i] for r in _spawns()[n].result()]


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _close_tree(got, want, rel):
    if isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, rel)
    else:
        _close(got, want, rel)


def _params_close(got, want):
    got = np.concatenate([np.ravel(g) for g in (got if isinstance(
        got, list) else [got])])
    want = np.concatenate([np.ravel(g) for g in (want if isinstance(
        want, list) else [want])])
    err = np.abs(got - want)
    assert err.mean() <= 2e-3 * LR, err.mean()
    assert (err > 1e-2 * LR).mean() <= 1e-3, (err > 1e-2 * LR).sum()


# --------------------------------------------------------------- JAX side

def _jax_cut(c):
    mesh = _jmesh(c)
    spar = _jcanvas(c, mesh)
    jsam = _jsampler(c, c["co"].shape[0])
    wy, wx = jsam.weight_matrices(c["jboxes"])
    fn = spar.cut_fn(jsam, with_sharp=c["sharp"], with_anchors=c["anchors"])
    shift = None if c.get("shift") is None else jnp.asarray(c["shift"])
    co, aw = jnp.asarray(c["co"]), jnp.asarray(c["anchor_w"])
    params = jax.tree.map(jnp.asarray, c["params"])

    def loss(p):
        out = fn(p, wy, wx, shift=shift)
        out = out if isinstance(out, tuple) else (out,)
        val, k = jnp.sum(out[0] * co), 1
        if c["sharp"]:
            val, k = val + 3.0 * out[1], 2
        if c["anchors"]:
            m, s = out[k]
            val = val + jnp.sum(m * aw[0]) + jnp.sum(s * aw[1])
        return val, out
    sharded = spar.shard(params)
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(sharded)
    return spar, out, _unpad(spar, g), np.asarray(jax.jit(spar.render)(
        sharded))


def _jax_prompts(pr):
    return ((jnp.asarray(pr[0]), jnp.asarray(pr[1]), jnp.float32(-1.0)),)


def _jax_steps(c):
    cfg, tree = _clip(tuple(TINY.items()))
    spar = _jcanvas(c, _jmesh(c))
    opt = jo.build_optimizer("adam_custom", LR)
    train = jsp.build_spatial_train_step(spar, _jsampler(c, c["samples"]),
                                         cfg, JSettings(**c["settings"]),
                                         opt)
    head = bundle = None
    if "head" in c:
        head = jax.tree.map(jnp.asarray, c["head"])
        bundle = (jax.tree.map(jnp.asarray, c["lpips"]),
                  jnp.asarray(c["img_in"]))
    p = spar.shard(jax.tree.map(jnp.asarray, c["params"]))
    st, prev, losses = opt.init(p), jnp.zeros((c["samples"], 32)), []
    clip = jax.tree.map(jnp.asarray, tree)
    for i, k in enumerate(c["keys"]):
        p, st, prev, loss = train(p, st, prev, clip, head, bundle,
                                  _jax_prompts(c["prompts"]), k, jnp.int32(i))
        losses.append(float(loss))
    return spar, losses, np.asarray(prev), _unpad(spar, p)


def _check_steps(n, i, c):
    spar, jl, jprev, jp = _jax_steps(c)
    ranks = _ranks(n, i)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-4)
        _close(r["enc"], jprev, 1e-3)
        _params_close(r["params"], jp)
        assert r["pad_max"] == 0.0
    return spar, ranks


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("canvas,size,wave", [
    ("fft", (64, 96), "coif2"), ("rgb", (50, 96), "coif2"),
    ("dwt", (128, 96), "db3")])
def test_shard_from_numpy_pads_as_jax(canvas, size, wave):
    """`convert.spatial_shard_from_numpy` gives rank r of 4 its part of
    JAX's canonical params and of an adam_custom state over them (after
    one update, so the moments are not zero): the ranks' parts, put
    together, are JAX's `shard` of the params and of each moment, pads
    included, exactly."""
    import torch
    from aphantasia_torch.cli.common import spatial_canvas
    from aphantasia_torch.convert import spatial_shard_from_numpy
    from aphantasia_torch.parallel.mesh import Mesh as TMesh
    c = dict(canvas=canvas, size=size, wave=wave, spatial=4)
    params = _canonical(canvas, size, 30, wave)
    opt = jo.build_optimizer("adam_custom", LR)
    jp = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(lambda x: jnp.sin(3.0 * x) + 0.1, jp)
    _, state = opt.update(grads, opt.init(jp), jp)
    spar_j = _jcanvas(c, _jmesh(c))
    axis = 3 if canvas != "rgb" else 2
    parts = []
    for r in range(4):
        mesh = TMesh(("spatial",), {"spatial": 4}, r, {"spatial": r},
                     torch.device("cpu"), None)
        spar = spatial_canvas(canvas, size, mesh, 1.5, 1.8, wave)
        parts.append(spatial_shard_from_numpy(spar, params, tree_np(state)))
    moments = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "nu"))
        if hasattr(s, "nu")][0]
    for got, want in ((lambda p: p[0], params),
                      (lambda p: p[1].mu, moments.mu),
                      (lambda p: p[1].nu, moments.nu)):
        whole = jax.tree.map(np.asarray, spar_j.shard(
            jax.tree.map(jnp.asarray, want)))
        leaves = [got(p) for p in parts]
        if canvas == "dwt":
            for j, ref in enumerate(whole):
                sharded = 1 <= j <= spar_j.k_fine
                cat = (np.concatenate([np.asarray(x[j]) for x in leaves],
                                      axis=3) if sharded
                       else np.asarray(leaves[0][j]))
                np.testing.assert_array_equal(cat, ref)
        else:
            np.testing.assert_array_equal(np.concatenate(
                [np.asarray(x) for x in leaves], axis=axis), whole)
    assert all(int(p[1].count) == int(moments.count) for p in parts)


@pytest.mark.parametrize("n,i", [(2, 0), (4, 0), (2, 1), (4, 1)],
                         ids=["fft-s2-shift", "fft-s4-shift", "dwt-s2",
                              "rgb-s4-h50"])
def test_cut_render_grad_match_jax(n, i):
    """The cut (with the noise shift on the FFT cases), the halo
    sharpness, the RGB anchors (H = 50 over 4 ranks: a container of 52),
    the render and the gradient of cuts, sharpness and anchors against
    JAX's `cut_fn` and `render`: FFT at S = 2 and 4, DWT at S = 2 with
    k_fine >= 1, RGB at S = 4.  Every rank holds the same cuts, render
    and gathered gradient, with zero gradient on its pads."""
    c = _cases()[n][i]
    spar, out, g, render = _jax_cut(c)
    if c["canvas"] == "dwt":
        assert spar.k_fine >= 1
    for r in _ranks(n, i):
        _close(r["cuts"], out[0], 2e-4)
        _close(r["render"], render, 2e-4)
        _close_tree(r["grad"], g, 2e-4)
        assert r["grad_pad"] == 0.0
        assert r["h_container"] == spar.h_container
        if c["canvas"] == "dwt":
            assert r["k_fine"] == spar.k_fine
        k = 1
        if c["sharp"]:
            np.testing.assert_allclose(r["sharp"], float(out[1]), rtol=1e-5)
            k = 2
        if c["anchors"]:
            for a, b in zip(r["anchors"], out[k]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("i", [2, 3], ids=["fft", "rgb-h51"])
def test_frame_warp_and_preview_match_jax(i):
    """`spatial_frame_warp` with a depth map (the gathered frame's depth
    warp and `frame_transform`, torch.fft where JAX multiplies by DFT
    matrices) and `spatial_depth_preview` at S = 2, against JAX's; RGB
    at H = 51 (a pad row)."""
    c = _cases()[2][i]
    spar = _jcanvas(c, _jmesh(c))
    p = spar.shard(jnp.asarray(c["params"]))
    warped = _unpad(spar, jax.jit(lambda q, m, d: jsp.spatial_frame_warp(
        spar, q, m, depth=c["depth"], depth_map=d))(
            p, tuple(jnp.float32(v) for v in c["motion"]),
            jnp.asarray(c["dmap"])))
    preview = np.asarray(jax.jit(lambda q: jsp.spatial_depth_preview(
        spar, q))(p))
    for r in _ranks(2, i):
        _close(r["warped"], warped, 2e-4)
        _close(r["preview"], preview, 2e-4)


def test_chunked_loop_with_dual_matches_jax():
    """`build_spatial_train_loop_frames` with `dual=(tiny2, 2)` (steps 2
    of 4 through the second tower) and the noise shift drawn at the
    padded spectrum (W = 96: one pad column at S = 2), four frame groups
    against JAX's loop: losses, frames, params; the pad column stays
    zero."""
    c = _cases()[2][4]
    cfg, tree = _clip(tuple(TINY.items()))
    cfg2, tree2 = _clip(tuple(TINY2.items()), 99)
    spar = _jcanvas(c, _jmesh(c))
    opt = jo.build_optimizer("adam_custom", LR)
    loop = jsp.build_spatial_train_loop_frames(
        spar, _jsampler(c, c["samples"]), cfg, JSettings(**c["settings"]),
        opt, 1, 4, dual=(cfg2, c["dm_every"]))
    p = spar.shard(jnp.asarray(c["params"]))
    p, _, _, frames, losses = loop(
        p, opt.init(p), jnp.zeros((c["samples"], 32)),
        jax.tree.map(jnp.asarray, tree), None, None,
        _jax_prompts(c["prompts"]), jax.tree.map(jnp.asarray, tree2), None,
        _jax_prompts(c["prompts2"]), c["key"], jnp.int32(0))
    for r in _ranks(2, 4):
        np.testing.assert_allclose(r["losses"], np.asarray(losses),
                                   rtol=1e-4)
        assert np.abs(r["frames"].astype(int)
                      - np.asarray(frames).astype(int)).max() <= 1
        _params_close(r["params"], _unpad(spar, p))
        assert r["pad_max"] == 0.0


@pytest.mark.parametrize("i", [2, 3, 4],
                         ids=["fft-every-d2s2", "rgb-every-d2s2",
                              "rgb-s4-h50-pads"])
def test_train_steps_match_jax(i):
    """Free-running sharded train steps against JAX's
    `build_spatial_train_step`: at data 2 x spatial 2 with every term
    (the noise shift on the FFT canvas, the anchors on RGB, sharpness, the
    aesthetic head, the LPIPS sync with random VGG16 weights, enforce,
    expand), and RGB at H = 50 over 4 ranks for three steps, whose pad
    rows must stay zero.  Every rank holds the same losses, encodings
    and gathered params."""
    _, ranks = _check_steps(4, i, _cases()[4][i])
    coords = sorted(tuple(r["coords"].values()) for r in ranks)
    assert len(set(coords)) == 4


@pytest.mark.parametrize("i", [0, 1, 2],
                         ids=["frame-d4s2-depth", "frame-d2s4",
                              "dwt-d4s2-kfine3"])
def test_multichip_layouts_at_8_ranks(i):
    """The spatial layouts of MULTICHIP_r05.json on 8 gloo ranks: the
    illustrip frame step (motion warp, two train steps, render) at data 4
    x spatial 2 (with a depth map and its preview) and data 2 x spatial
    4, and the DWT train step at data 4 x spatial 2 (64x64, db2: k_fine
    = 3, its pads zero after two steps), against JAX on 8 virtual
    devices."""
    c = _cases()[8][i]
    if c["kind"] == "steps":
        spar, _ = _check_steps(8, i, c)
        assert spar.k_fine == 3
        return
    cfg, tree = _clip(tuple(TINY.items()))
    spar = _jcanvas(c, _jmesh(c))
    opt = jo.build_optimizer("adam_custom", LR)
    depth = c.get("dmap") is not None
    fn = jsp.build_spatial_frame_step(
        spar, _jsampler(c, c["samples"]), cfg, JSettings(**c["settings"]),
        opt, 2, smooth=False, contrast=c["contrast"],
        deptha=object() if depth else None, depth=1.0 if depth else 0.0)
    p = spar.shard(jnp.asarray(c["params"]))
    args = (p, opt.init(p), jnp.zeros((c["samples"], 32)),
            jax.tree.map(jnp.asarray, tree), None, _jax_prompts(c["prompts"]),
            c["key"], jnp.int32(1), tuple(jnp.float32(v) for v in MOTION))
    out = fn(*args, jnp.asarray(c["dmap"])) if depth else fn(*args)
    for r in _ranks(8, i):
        np.testing.assert_allclose(r["losses"], np.asarray(out[4]),
                                   rtol=1e-4)
        _params_close(r["params"], _unpad(spar, out[0]))
        assert np.abs(r["frame"].astype(int)
                      - np.asarray(out[3]).astype(int)).max() <= 1
        assert r["pad_max"] == 0.0
        if depth:
            _close(r["preview"], np.asarray(out[5]), 2e-4)


# --------------------------------------------------------------- the witness

@functools.lru_cache(None)
def _witness_inputs():
    """JAX's spatial witness inputs (one-host anchor, data 2 x spatial 2)."""
    from aphantasia_tpu.ops.sampler import CutoutSampler
    from aphantasia_tpu.parallel.step import StepSettings
    cfg = jm.CLIPConfig(**TINY)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "spatial"))
    spar = jsp.SpatialFFT((32, 64), 1.5, 1.8, mesh)
    sampler = CutoutSampler((32, 64), 4, 32, align="uniform", macro=0.4)
    settings = StepSettings(sim="mix", transform="fast", total_steps=10)
    params = jsp.unpad_spectrum(spar.init(jax.random.PRNGKey(1), sd=0.01),
                                64)
    return dict(
        clip=tree_np(jm.clip_init(jax.random.PRNGKey(0), cfg)),
        params=np.asarray(params),
        embs=np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 32))),
        draws=jax_step_draws(jax.random.PRNGKey(3), sampler, settings,
                             (1, 3) + spar.scale.shape[2:4] + (2,)))


def _host(rank, world, coord, n_local, out):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "aphantasia_torch.parallel.dcn", str(rank),
         str(world), coord, str(n_local), str(out), "spatial", "--device",
         "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def test_spatial_witness_hosts_match_jax_anchor(tmp_path):
    """The spatial DCN witness as 2 host processes x 2 gloo ranks (data =
    hosts, spatial = a host's ranks) and as JAX's one-host anchor layout
    (1 process x 4 ranks split into data 2): one loss and digest; on
    JAX's inputs the step matches JAX's `witness_spatial_step` on a data 2
    x spatial 2 mesh of 4 virtual devices."""
    from aphantasia_tpu.parallel import dcn
    port = free_port()
    procs = [_host(r, 2, f"127.0.0.1:{port}", 2, tmp_path / f"r{r}.json")
             for r in range(2)]
    procs.append(_host(0, 1, "none", 4, tmp_path / "one.json"))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "spatial"))
    jl, jd = dcn.witness_spatial_step(mesh)
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    recs = [json.loads((tmp_path / f).read_text())
            for f in ("r0.json", "r1.json", "one.json")]
    for r in recs:
        assert r["n_devices"] == 4
        assert r["mesh"] == {"data": 2, "spatial": 2}
    assert [r["n_local"] for r in recs] == [2, 2, 4]
    assert recs[0]["loss"] == recs[1]["loss"]
    assert recs[0]["digest"] == recs[1]["digest"]
    np.testing.assert_allclose(recs[0]["loss"], recs[2]["loss"], rtol=1e-6)
    np.testing.assert_allclose(recs[0]["digest"], recs[2]["digest"],
                               rtol=1e-6)
    got = _ranks(4, 5)
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0][0], jl, atol=2.5e-4)
    np.testing.assert_allclose(got[0][1], jd, rtol=1e-3)


# ------------------------------------------------------------------ the CLIs

TINY_ARGS = ["--samples", "4", "--steps", "2", "-nv", "--device", "cpu",
             "-tf", "none"]


@pytest.fixture
def tiny_cli(monkeypatch):
    from aphantasia_torch.models.clip import model as tm
    from aphantasia_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_FLEET", None)
    monkeypatch.setattr(multihost, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    monkeypatch.setitem(tm.CLIP_CONFIGS, "ViT-B/32",
                        tm.CLIPConfig(**_torch_dist.TINY_MESH_B32))


def test_clip_fft_spatial_cli_and_dense_resume(tmp_path, tiny_cli):
    """clip_fft --spatial 2 on two gloo ranks (the chunked loop, rank 0
    writing): the dense run's files, its losses within 1e-4 relative,
    the `.pt` a list of the canonical [1,3,64,49,2] spectrum, which a
    dense --resume reads; --dwt --spatial 2 saves the canonical pyramid.
    No child is left."""
    import multiprocessing
    from aphantasia_torch.cli import clip_fft
    from aphantasia_torch.cli.common import run_cli
    from aphantasia_torch.io.checkpoint import load_pt
    base = ["-t", "x", "--size", "96-64", "--save_pt"] + TINY_ARGS
    runs = {}
    for name, extra in (("dense", []), ("sp", ["--spatial", "2"]),
                        ("dwt", ["--spatial", "2", "--dwt"])):
        out = str(tmp_path / name)
        a = clip_fft.get_args(base + ["--out_dir", out] + extra)
        res = run_cli(a, _torch_dist.tiny_clip_fft)
        runs[name] = (res, sorted(os.listdir(out)),
                      load_pt(os.path.join(out, res.out_name + ".pt")))
    (dense, files, dpt), (sp, sp_files, spt) = runs["dense"], runs["sp"]
    assert sp_files == files
    np.testing.assert_allclose(sp.losses, dense.losses, rtol=1e-4)
    assert [p.shape for p in spt] == [(1, 3, 64, 49, 2)]
    np.testing.assert_array_equal(spt[0], np.asarray(sp.params))
    want = dwt_shapes((64, 96), "coif2", dwt_max_level(64))
    assert [tuple(p.shape) for p in runs["dwt"][2]] == [tuple(s)
                                                       for s in want]
    pt = str(tmp_path / "sp" / (sp.out_name + ".pt"))
    a = clip_fft.get_args(["-t", "x", "--size", "96-64", "-r", pt, "--out_dir",
                           str(tmp_path / "resumed")] + TINY_ARGS)
    res = run_cli(a, _torch_dist.tiny_clip_fft)
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert multiprocessing.active_children() == []


def test_illustra_and_illustrip_spatial_cli(tmp_path, tiny_cli):
    """illustra --spatial 2 over two scenes (keep-chained, the range
    taken over both ranks): a bare canonical [1,3,64,49,2] `.pt` a scene
    and the crossfade; illustrip --spatial 2 (--gen RGB, H = 64) writes
    its frames and returns the canonical [1,3,64,96] state."""
    from aphantasia_torch.cli import illustra, illustrip
    from aphantasia_torch.cli.common import run_cli
    from aphantasia_torch.io.checkpoint import load_pt
    txt = tmp_path / "scenes.txt"
    txt.write_text("first scene\nsecond scene\n")
    out = tmp_path / "ra"
    a = illustra.get_args(["-t", str(txt), "--size", "96-64", "--lsteps", "2",
                           "--out_dir", str(out), "--spatial", "2", "--aest",
                           "0"] + TINY_ARGS)
    res = run_cli(a, _torch_dist.tiny_illustra)
    pts = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    assert len(pts) == 2 and res.final_frames == 4
    for f in pts:
        assert load_pt(str(out / f)).shape == (1, 3, 64, 49, 2)
    assert "scenes.mp4" in os.listdir(out)
    b = illustrip.get_args(["-t", str(txt), "--size", "96-64", "--steps",
                            "2", "--samples", "2", "-nv", "--device", "cpu",
                            "-tf", "none", "--out_dir",
                            str(tmp_path / "rp"), "--spatial", "2"])
    res = run_cli(b, _torch_dist.tiny_illustrip)
    assert res.frames == 4 and res.params.shape == (1, 3, 64, 96)
    assert len(os.listdir(os.path.join(res.workdir, "ttt"))) == 4
