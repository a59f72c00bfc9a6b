"""The port's data and model mesh axes (aphantasia_torch/parallel/mesh.py,
the `mesh=` of aphantasia_torch/step.py, the tensor-parallel blocks of
models/clip/model.py) against the JAX package on the CPU: gloo ranks
spawned by the port's launcher (workers in tests/_torch_dist.py) against
JAX on the conftest's 8 virtual CPU devices, on the same draws and
converted weights.  Also the one-rank mesh step against the dense step
and the launcher's clean-up after a failing rank.

Tolerances (float32; the `none` transform keeps the step float32):
* data axis, two free-running steps: losses 1e-4 relative, the last
  encodings 1e-3 absolute, the params 2e-3 of the learning rate in the
  mean and 5e-2 of it at the worst element (tests/test_torch_step.py's);
* model axis: encodings within 1e-5 of max |ref|, input gradients within
  1e-4 of max |ref| (tests/test_torch_resnet.py's);
* the one-rank mesh step equals the dense step bit for bit.

clip_fft's --mesh runs are held to its dense run in
tests/test_torch_dcn.py::test_clip_fft_mesh_matches_dense."""
import functools
import multiprocessing

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.params.fft import FFTParameterizer as JFFT
from aphantasia_tpu.parallel import mesh as jmesh
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.convert import clip_params_from_numpy
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer
from aphantasia_torch.parallel import mesh as tmesh

from _torch_parity import jax_step_draws, tree_np
import _torch_dist

VIT = dict(name="tiny", embed_dim=32, image_resolution=32, vision_layers=2,
           vision_width=128, vision_patch_size=8, context_length=16,
           vocab_size=256, transformer_width=64, transformer_heads=2,
           transformer_layers=2)
RN = dict(name="rn-tiny", embed_dim=16, image_resolution=32,
          vision_layers=(1, 1, 1, 1), vision_width=8, vision_patch_size=0,
          context_length=12, vocab_size=100, transformer_width=16,
          transformer_heads=2, transformer_layers=1)
H, W, LR, STEPS = 48, 64, 0.05, 2
PLAIN = dict(transform="none", noise=0.1, expand=0.5)
EVERY = dict(transform="none", noise=0.1, expand=0.5, aest=2.0, sharp=0.2,
             enforce=0.3, sync=0.5, total_steps=5, rgb_anchors=True)
# (ranks, samples, terms): one spawn of each rank count runs its cases
DATA_CASES = {"n2-s8": (2, 8, PLAIN), "n4-s8-every": (4, 8, EVERY),
              "n4-s10": (4, 10, PLAIN)}


def _plan(n):
    return tmesh.Plan(n, f"127.0.0.1:{tmesh.free_port()}", "cpu")


@functools.lru_cache(None)
def _clip(kw_items):
    """A JAX config and random weights in its tree's layout, from a seed
    with numpy (the shapes from `jax.eval_shape` of `clip_init`): gains
    and variances about 1, biases and means about 0, the other leaves
    normal over the square root of their fan-in."""
    cfg = jm.CLIPConfig(**dict(kw_items))
    shapes = jax.eval_shape(lambda k: jm.clip_init(k, cfg),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)

    def leaf(path, x):
        name = path[-1].key
        if x.ndim == 0:
            return np.float32(np.log(1 / 0.07))
        if x.ndim == 1:
            if name in ("g", "v"):
                return (1 + 0.1 * rs.rand(*x.shape)).astype(np.float32)
            return (0.1 * rs.randn(*x.shape)).astype(np.float32)
        fan = int(np.prod(x.shape[:-1]))
        return (rs.randn(*x.shape) / np.sqrt(fan)).astype(np.float32)
    return cfg, jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(None)
def _data_case(name):
    """The case's inputs: the port's (for the workers) and JAX's."""
    from aphantasia_tpu.models.lpips import lpips_init
    _, s, kw = DATA_CASES[name]
    rs = np.random.RandomState(1)
    p0 = (0.07 * rs.randn(1, 3, H, W // 2 + 1, 2)).astype(np.float32)
    embs = rs.randn(2, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    jset = jstep.StepSettings(sim="mix", clip_dtype=jnp.float32, **kw)
    jsam = JSampler((H, W), s, 32, "uniform", 0.4)
    key = jax.random.PRNGKey(3)
    keys = [jax.random.fold_in(key, i) for i in range(STEPS)]
    case = dict(size=(H, W), samples=s, settings=kw, lr=LR, p0=p0,
                prompts=(embs, wts), keys=keys,
                draws=[jax_step_draws(k, jsam, jset, p0.shape) for k in keys])
    if "aest" in kw:
        case["head"] = {"w": (0.1 * rs.randn(32, 1)).astype(np.float32),
                        "b": np.asarray([0.2], np.float32)}
        case["lpips"] = tree_np(lpips_init(jax.random.PRNGKey(1)))
        case["img_in"] = rs.rand(1, 3, H // 2, W // 2).astype(np.float32)
    return case, jset, jsam


def _data_spawn(n):
    """The port's results for every case of `n` ranks, one spawn."""
    names = [k for k, v in DATA_CASES.items() if v[0] == n]
    cases = [{k: v for k, v in _data_case(m)[0].items() if k != "keys"}
             for m in names]
    _, tree = _clip(tuple(VIT.items()))
    res = tmesh.spawn(_torch_dist.data_axis_worker, (VIT, tree, cases),
                      _plan(n))
    return {m: [r[i] for r in res] for i, m in enumerate(names)}


def _model_spawn(spec):
    return tmesh.spawn(_torch_dist.model_axis_worker,
                       (spec, _model_inputs()), _plan(spec[0] * spec[1]))


@functools.lru_cache(None)
def _spawns():
    """Every spawn of the file, one after the other on a background
    thread, and the model axis' JAX references on another, so that the
    ranks compute and both JAX compiles run while this thread compiles
    the data axis' JAX steps: {key: future}."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    jax_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    for name in DATA_CASES:        # the inputs, made here with JAX first
        _data_case(name)
    cases = _model_inputs()
    out = {n: pool.submit(_data_spawn, n) for n in (2, 4)}
    for spec in ((2, 2), (4, 2)):
        out[spec] = pool.submit(_model_spawn, spec)
        out["jax", spec] = [jax_pool.submit(_jax_model, spec, c)
                            for c in cases]
    pool.shutdown(wait=False)
    jax_pool.shutdown(wait=False)
    return out


def _jax_steps(name):
    """JAX `build_train_step(mesh=make_mesh(n))`, free-running."""
    n = DATA_CASES[name][0]
    case, jset, jsam = _data_case(name)
    jcfg, tree = _clip(tuple(VIT.items()))
    opt = jo.build_optimizer("adam_custom", LR, STEPS)
    train = jstep.build_train_step(JFFT((H, W), 1.5, 1.8), jsam, jcfg, jset,
                                   opt, mesh=jmesh.make_mesh(n))
    head = bundle = None
    if "head" in case:
        head = jax.tree.map(jnp.asarray, case["head"])
        bundle = (jax.tree.map(jnp.asarray, case["lpips"]),
                  jnp.asarray(case["img_in"]))
    embs, wts = case["prompts"]
    prompts = ((jnp.asarray(embs), jnp.asarray(wts), jnp.float32(-1.0)),)
    p = jnp.asarray(case["p0"])
    st, prev = opt.init(p), jnp.zeros((case["samples"], 32))
    clip = jax.tree.map(jnp.asarray, tree)
    losses = []
    for i, k in enumerate(case["keys"]):
        p, st, prev, loss = train(p, st, prev, clip, head, bundle, prompts,
                                  k, jnp.int32(i))
        losses.append(float(loss))
    return losses, np.asarray(prev), np.asarray(p)


@pytest.mark.parametrize("name", list(DATA_CASES))
def test_data_axis_matches_jax(name):
    """Two steps on n gloo ranks against JAX's step over an n-device data
    mesh: S = 8 at 2 ranks, S = 8 at 4 ranks with every term on (the
    aesthetic head, sharpness, enforce, expand, the RGB anchors, noise and
    the LPIPS sync with random VGG16 weights), and S = 10 over 4 ranks
    (shards of 3, 3, 2 and 2 rows).  Every rank holds the same result."""
    n, s, _ = DATA_CASES[name]
    ranks = _spawns()[n].result()[name]
    jl, jprev, jp = _jax_steps(name)
    bounds = [r["rows"] for r in ranks]      # in order, sizes within one
    assert [b[0] for b in bounds] == [0] + [b[1] for b in bounds[:-1]]
    assert bounds[-1][1] == s
    sizes = [b[1] - b[0] for b in bounds]
    assert max(sizes) - min(sizes) <= 1
    for r in ranks:
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-4)
        np.testing.assert_allclose(r["enc"], jprev, atol=1e-3)
        err = np.abs(r["params"] - jp)
        assert err.mean() <= 2e-3 * LR, err.mean()
        assert err.max() <= 5e-2 * LR, err.max()


def test_one_rank_mesh_step_equals_dense():
    """A data mesh of one rank (an in-process gloo group) runs the dense
    step's operations plus collectives of one rank: two steps with every
    term on give the same bits."""
    from aphantasia_torch.convert import (aesthetic_params_from_numpy,
                                          lpips_params_from_numpy)
    case, _, _ = _data_case("n4-s8-every")
    cfg = tm.CLIPConfig(**VIT)
    clip = clip_params_from_numpy(_clip(tuple(VIT.items()))[1])
    head = aesthetic_params_from_numpy(case["head"])
    bundle = (lpips_params_from_numpy(case["lpips"]),
              torch.tensor(case["img_in"]))
    embs, wts = case["prompts"]
    prompts = ((torch.tensor(embs), torch.tensor(wts), -1.0),)

    def run(mesh):
        sett = tstep.StepSettings(sim="mix", **EVERY)
        opt = to.build_optimizer("adam_custom", LR, STEPS)
        train = tstep.build_train_step(
            FFTParameterizer((H, W), 1.5, 1.8),
            CutoutSampler((H, W), 8, 32, "uniform", 0.4), cfg, sett, opt,
            mesh=mesh)
        p = torch.tensor(case["p0"])
        st, prev, losses = opt.init(p), torch.zeros((8, 32)), []
        for i, d in enumerate(case["draws"]):
            p, st, prev, loss = train(p, st, prev, clip, head, bundle,
                                      prompts, d, i)
            losses.append(loss)
        return torch.stack(losses), prev, p

    dense = run(None)
    from aphantasia_torch import kernels
    kernels.reset_launches()
    meshed = tmesh.launch(lambda: run(tmesh.make_mesh(1)), (), _plan(1))
    # enforce encodes twice a step: two gathers, one gradient sum
    assert kernels.LAUNCHES["all_gather"] == 2 * STEPS
    assert kernels.LAUNCHES["all_reduce"] == STEPS
    for a, b in zip(dense, meshed):
        assert torch.equal(a, b)


@functools.lru_cache(None)
def _model_inputs():
    rs = np.random.RandomState(4)
    cases = []
    for kw in (VIT, RN):
        cfg, tree = _clip(tuple(kw.items()))
        toks = rs.randint(1, kw["vocab_size"] - 1,
                          (3, kw["context_length"])).astype(np.int32)
        toks[:, -3] = kw["vocab_size"] - 1           # the EOT, argmax
        cases.append(dict(
            cfg=kw, clip=tree, tokens=toks,
            images=rs.randn(8, 3, 32, 32).astype(np.float32),
            img_cot=rs.randn(8, kw["embed_dim"]).astype(np.float32),
            txt_cot=rs.randn(3, kw["embed_dim"]).astype(np.float32)))
    return cases


def _jax_model(spec, case):
    """JAX encodings and input gradients with `shard_clip_params` on
    `make_mesh_2d(*spec)`."""
    cfg = jm.CLIPConfig(**case["cfg"])
    sp = jmesh.shard_clip_params(jax.tree.map(jnp.asarray, case["clip"]),
                                 jmesh.make_mesh_2d(*spec))

    @jax.jit
    def run(sp, x, toks, ci, ct):
        enc, vjp = jax.vjp(lambda y: jm.encode_image(sp, cfg, y), x)

        def text(te):
            return jm.encode_text(dict(sp, text=dict(sp["text"],
                                                     token_embedding=te)),
                                  cfg, toks)
        tenc, tvjp = jax.vjp(text, sp["text"]["token_embedding"])
        return enc, vjp(ci)[0], tenc, tvjp(ct)[0]
    return [np.asarray(v) for v in run(
        sp, jnp.asarray(case["images"]), jnp.asarray(case["tokens"]),
        jnp.asarray(case["img_cot"]), jnp.asarray(case["txt_cot"]))]


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("spec", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_model_axis_matches_jax(spec):
    """Image and text encodings and their input gradients (the images';
    the token-embedding table's for the text tower) of a tiny ViT and a
    tiny ResNet, each rank of a data x model mesh against JAX with
    `shard_clip_params` on `make_mesh_2d`: every rank holds its data
    rows' image encodings and the whole text encodings."""
    cases = _model_inputs()
    ranks = _spawns()[spec].result()
    for i, case in enumerate(cases):
        enc, gx, tenc, gt = _spawns()["jax", spec][i].result()
        for r in ranks:
            got = r[i]
            rows = slice(*got["rows"])
            _close(got["enc"], enc[rows], 1e-5)
            _close(got["gx"], gx[rows], 1e-4)
            _close(got["tenc"], tenc, 1e-5)
            _close(got["gt"], gt, 1e-4)
    assert sorted(tuple(r[0]["coords"].values()) for r in ranks) == [
        (d, m) for d in range(spec[0]) for m in range(spec[1])]


def test_heads_that_do_not_divide_raise(monkeypatch):
    """A model axis that does not divide a tower's heads raises; a shard
    holds its head group and MLP slice and shares the whole leaves; the
    fused half blocks, which fuse whole products, refuse a shard."""
    cfg = tm.CLIPConfig(**VIT)
    params = clip_params_from_numpy(_clip(tuple(VIT.items()))[1])
    with pytest.raises(ValueError, match="heads do not split"):
        tmesh.shard_clip_params(params, (0, 4), cfg)
    half = tmesh.shard_clip_params(params, (1, 2), cfg)
    blk = half["visual"]["blocks"][0]
    assert blk["attn"]["in_w"].shape == (128, 192)
    assert blk["mlp"]["proj_w"].shape == (256, 128)
    assert tm.model_split(blk) == 2
    assert half["visual"]["conv"] is params["visual"]["conv"]
    monkeypatch.setenv("APHANTASIA_FUSED_BLOCK", "1")
    with pytest.raises(NotImplementedError, match="model axis"):
        tm.encode_image(half, cfg, torch.zeros((2, 3, 32, 32)))


def test_failing_rank_leaves_no_child():
    """Rank 1 raises while rank 0 waits in a barrier: the launch raises
    naming the rank, and no child process is left."""
    with pytest.raises(RuntimeError, match="mesh rank 1"):
        tmesh.spawn(_torch_dist.failing_worker, (1,), _plan(2))
    assert multiprocessing.active_children() == []

