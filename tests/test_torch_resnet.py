"""The port's ModifiedResNet CLIP towers (aphantasia_torch/models/clip/
model.py: `_bn`, `bottleneck`, `attnpool`, `resnet_encode`) against the
JAX package's functions on the CPU, float32: forward within 1e-5 of max
|ref|, the gradient with respect to the input within 1e-4 of max |ref|.
Inputs are made from a seed with numpy; the JAX tree is converted with
`clip_params_from_numpy` (its convolutions HWIO -> OIHW).  Also: the
`clip_init` shapes of the five published ResNets, the two checkpoint
converters on one OpenAI-layout checkpoint, and three train steps of a
tiny ResNet against JAX `build_train_step` on the JAX step's draws, with
and without the `--pallas` gather."""
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
from aphantasia_torch.convert import (clip_params_from_numpy,
                                      fft_params_from_numpy)
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer

from _torch_parity import jax_step_draws, tree_np

# tests/test_clip.py's tiny ResNet, and one with two blocks in a stage
TINY = dict(name="rn-tiny", embed_dim=16, image_resolution=32,
            vision_layers=(1, 1, 1, 1), vision_width=8, vision_patch_size=0,
            context_length=12, vocab_size=100, transformer_width=16,
            transformer_heads=2, transformer_layers=1)
TINY2 = dict(TINY, name="rn-tiny2", image_resolution=64,
             vision_layers=(1, 2, 1, 1))
RESNETS = ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64")


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


def _vjp_jax(fn, x, co):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(co))[0])


def _vjp_torch(fn, x, co):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    (g,) = torch.autograd.grad(out, xt, torch.tensor(co))
    return out.detach().numpy(), g.numpy()


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _bn_params(rs, c):
    return {"g": (1 + 0.2 * rs.randn(c)).astype(np.float32),
            "b": (0.1 * rs.randn(c)).astype(np.float32),
            "m": (0.1 * rs.randn(c)).astype(np.float32),
            "v": (0.5 + rs.rand(c)).astype(np.float32)}


def _jax_tree(p):
    return jax.tree.map(jnp.asarray, p)


def test_bn_matches_jax():
    """The frozen BatchNorm with statistics away from 0 and 1."""
    rs = np.random.RandomState(0)
    p = _bn_params(rs, 8)
    x = rs.randn(2, 5, 6, 8).astype(np.float32)            # NHWC
    want = jm._bn(jnp.asarray(x), _jax_tree(p))
    got = tm._bn(torch.tensor(_nchw(x)),
                 {k: torch.tensor(v) for k, v in p.items()})
    _close(got.numpy(), _nchw(want), 1e-5)


@pytest.mark.parametrize("inplanes,planes,stride,down", [
    (16, 4, 1, False), (8, 4, 1, True), (16, 8, 2, True)])
def test_bottleneck_matches_jax(inplanes, planes, stride, down):
    """A bottleneck at stride 1 without and with a downsample, and at
    stride 2 (the avgpool before conv3 and before the downsample conv),
    on an odd 7x9 map (the stride-2 pools drop the last row and column)."""
    rs = np.random.RandomState(1)

    def conv(k, cin, cout):
        return (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                ).astype(np.float32)
    p = {"conv1_w": conv(1, inplanes, planes), "bn1": _bn_params(rs, planes),
         "conv2_w": conv(3, planes, planes), "bn2": _bn_params(rs, planes),
         "conv3_w": conv(1, planes, planes * 4),
         "bn3": _bn_params(rs, planes * 4)}
    if down:
        p["down_conv_w"] = conv(1, inplanes, planes * 4)
        p["down_bn"] = _bn_params(rs, planes * 4)
    x = rs.randn(2, 7, 9, inplanes).astype(np.float32)
    ho, wo = (7 // stride, 9 // stride)
    co = rs.randn(2, ho, wo, planes * 4).astype(np.float32)
    jp, tp = _jax_tree(p), clip_params_from_numpy(p)
    out_j, g_j = _vjp_jax(lambda v: jm.bottleneck(v, jp, stride), x, co)
    out_t, g_t = _vjp_torch(lambda v: tm.bottleneck(v, tp, stride),
                            _nchw(x), _nchw(co))
    _close(out_t, _nchw(out_j), 1e-5)
    _close(g_t, _nchw(g_j), 1e-4)


def test_attnpool_matches_jax():
    """The mean-query attention pool over a 3x4 map of width 256 (4 heads
    of 64), its token order the NHWC row-major (h, w) order."""
    rs = np.random.RandomState(2)
    c, e, hw = 256, 24, (3, 4)
    s = c ** -0.5
    p = {"pos_emb": (s * rs.randn(hw[0] * hw[1] + 1, c)).astype(np.float32)}
    for n in "qkv":
        p[n + "_w"] = (s * rs.randn(c, c)).astype(np.float32)
        p[n + "_b"] = (0.1 * rs.randn(c)).astype(np.float32)
    p["c_w"] = (s * rs.randn(c, e)).astype(np.float32)
    p["c_b"] = (0.1 * rs.randn(e)).astype(np.float32)
    x = rs.randn(2, *hw, c).astype(np.float32)
    co = rs.randn(2, e).astype(np.float32)
    jp, tp = _jax_tree(p), clip_params_from_numpy(p)
    out_j, g_j = _vjp_jax(lambda v: jm.attnpool(v, jp, 4), x, co)
    out_t, g_t = _vjp_torch(lambda v: tm.attnpool(v, tp, 4), _nchw(x), co)
    _close(out_t, out_j, 1e-5)
    _close(g_t, _nchw(g_j), 1e-4)


@pytest.mark.parametrize("kw", [TINY, TINY2], ids=["1111-32", "1211-64"])
def test_resnet_encode_matches_jax(kw):
    """The whole image tower (`encode_image`) from the JAX `clip_init`
    tree converted by `clip_params_from_numpy`: the stem's stride-2
    (1, 1)-padded conv, the stages, the attention pool."""
    jcfg, tcfg = jm.CLIPConfig(**kw), tm.CLIPConfig(**kw)
    jp = jm.clip_init(jax.random.PRNGKey(1), jcfg)
    tp = clip_params_from_numpy(tree_np(jp))
    res = kw["image_resolution"]
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, res, res).astype(np.float32)
    co = rs.randn(2, kw["embed_dim"]).astype(np.float32)
    out_j, g_j = _vjp_jax(lambda v: jm.encode_image(jp, jcfg, v), x, co)
    out_t, g_t = _vjp_torch(lambda v: tm.encode_image(tp, tcfg, v), x, co)
    _close(out_t, out_j, 1e-5)
    _close(g_t, g_j, 1e-4)


def _jax_layout(tree):
    """The port's tree of tensors with its convolutions back in HWIO."""
    def leaf(x):
        a = x.detach().numpy() if isinstance(x, torch.Tensor) else x
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("name", RESNETS)
def test_resnet_init_shapes_match_jax(name, monkeypatch):
    """Each published ResNet's `clip_init` tree has the JAX tree's leaves
    and shapes (the convolutions' OIHW read as HWIO), shape-only on both
    sides: jax.eval_shape, and the port's tree on the meta device, so no
    RN50x64 (623M parameters) is allocated."""
    ref = jax.eval_shape(lambda k: jm.clip_init(k, jm.CLIP_CONFIGS[name]),
                         jax.random.PRNGKey(0))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    mine = tm.clip_init(torch.Generator(), tm.CLIP_CONFIGS[name])

    def shape(x):
        s = tuple(x.shape)
        return (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
    assert (jax.tree.map(shape, mine)
            == jax.tree.map(lambda a: tuple(a.shape), ref))
    cfg = tm.CLIP_CONFIGS[name]
    assert cfg.vision_width * 32 // cfg.vision_heads == 64


def test_resnet_checkpoint_converts_alike(tmp_path):
    """A tiny ResNet checkpoint in the OpenAI layout, written from the
    port's tree by `openai_state_dict` as fp16 (as OpenAI's releases store
    them), read by both packages' converters: the same tree (conv leaves
    compared in the JAX layout), equal to the written one rounded to
    fp16; both towers give the same embeddings.  A HuggingFace-named state
    dict without a ViT vision tower raises by name."""
    from aphantasia_tpu.models.clip import convert as jconv
    from aphantasia_torch.models.clip import convert as tconv
    cfg = tm.CLIPConfig(**TINY2)
    written = tm.clip_init(torch.Generator().manual_seed(4), cfg)
    sd = {k: v.half() for k, v in tconv.openai_state_dict(written).items()}
    assert "visual.layer2.1.conv3.weight" in sd
    assert "visual.layer2.0.downsample.1.running_var" in sd
    path = str(tmp_path / "rn.pt")
    torch.save(sd, path)
    mine = tconv.convert_checkpoint(path, expect_cfg=cfg)
    ref = jconv.convert_checkpoint(path, expect_cfg=jm.CLIPConfig(**TINY2))
    for a, b in zip(jax.tree.leaves(_jax_layout(mine)),
                    jax.tree.leaves(tree_np(ref)), strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(written),
                    strict=True):
        assert torch.equal(a, b.half().float())
    x = np.random.RandomState(5).randn(2, 3, 64, 64).astype(np.float32)
    _close(tm.encode_image(mine, cfg, torch.tensor(x)).numpy(),
           jm.encode_image(ref, jm.CLIPConfig(**TINY2), jnp.asarray(x)), 1e-5)
    with pytest.raises(ValueError, match="stages"):
        tconv.convert_checkpoint(path, expect_cfg=tm.CLIPConfig(**TINY))
    with pytest.raises(ValueError, match="ModifiedResNet"):
        tconv.convert_hf_clip({"text_model.embeddings.token_embedding.weight":
                               np.zeros((4, 2), np.float32)})


@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
def test_resnet_train_step_matches_jax(pallas):
    """Three train steps of the tiny ResNet (the second config: two blocks
    in stage 2, 64 px cutouts) against JAX `build_train_step` on the JAX
    step's draws, the `none` transform, float32.  The einsum cut runs free
    with the ViT step's tolerances (tests/test_torch_step.py): losses 1e-4
    relative, params 2e-3 of the learning rate in the mean and 5e-2 at the
    worst element.  The `--pallas` gather (JAX's Pallas kernel in
    interpret mode) rounds the frame to bf16, and a float32 ulp of the
    decode flips such a rounding (JAX's jitted step and its eager loss
    already part there), which Adam with b1 = 0 turns into full-size
    updates; so that case is held at each step of the JAX trajectory:
    loss 1e-4 relative, gradient 1e-3 relative L2 error."""
    lr, h, w, s = 0.05, 48, 80, 3
    kw = dict(TINY2, embed_dim=32)
    jcfg, tcfg = jm.CLIPConfig(**kw), tm.CLIPConfig(**kw)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    tclip = clip_params_from_numpy(tree_np(jclip))
    p0 = (0.07 * np.random.RandomState(1).randn(1, 3, h, w // 2 + 1, 2)
          ).astype(np.float32)
    embs = np.random.RandomState(2).randn(2, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    kws = dict(sim="mix", transform="none", noise=0.1, sharp=0.2)
    jset = jstep.StepSettings(clip_dtype=jnp.float32, **kws)
    tset = tstep.StepSettings(clip_dtype=torch.float32, **kws)
    jsam = JSampler((h, w), s, 64, "uniform", 0.4, use_pallas=pallas)
    tsam = CutoutSampler((h, w), s, 64, "uniform", 0.4, use_pallas=pallas)
    jpar, tpar = JFFT((h, w), 1.5, 1.8), FFTParameterizer((h, w), 1.5, 1.8)
    jopt = jo.build_optimizer("adam_custom", lr, 3)
    topt = to.build_optimizer("adam_custom", lr, 3)
    jtrain = jstep.build_train_step(jpar, jsam, jcfg, jset, jopt)
    ttrain = tstep.build_train_step(tpar, tsam, tcfg, tset, topt)
    jloss = jstep.build_loss_fn(jpar, jsam, jcfg, jset)
    tloss = tstep.build_loss_fn(tpar, tsam, tcfg, tset)
    jprompts = ((jnp.asarray(embs), jnp.asarray(wts), jnp.float32(-1.0)),)
    tprompts = ((torch.tensor(embs), torch.tensor(wts), -1.0),)
    jp = jnp.asarray(p0)
    js, jprev = jopt.init(jp), jnp.zeros((s, 32))
    tp = fft_params_from_numpy(p0)
    ts, tprev = topt.init(tp), torch.zeros((s, 32))
    key = jax.random.PRNGKey(7)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        draws = jax_step_draws(k, jsam, jset, p0.shape)
        if pallas:
            (lj, _), gj = jax.value_and_grad(jloss, has_aux=True)(
                jp, jclip, None, None, jprompts, jprev, k, i)
            x = torch.tensor(np.array(jp), requires_grad=True)
            lt, _ = tloss(x, tclip, None, None, tprompts,
                          torch.tensor(np.array(jprev)), draws, i)
            (gt,) = torch.autograd.grad(lt, x)
            np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-4)
            gj = np.asarray(gj)
            assert np.linalg.norm(gt.numpy() - gj) <= 1e-3 * np.linalg.norm(gj)
        jp, js, jprev, jl = jtrain(jp, js, jprev, jclip, None, None,
                                   jprompts, k, jnp.int32(i))
        if not pallas:
            tp, ts, tprev, tl = ttrain(tp, ts, tprev, tclip, None, None,
                                       tprompts, draws, i)
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4,
                                       atol=1e-4)
    if not pallas:
        err = np.abs(tp.numpy() - np.asarray(jp))
        assert err.mean() <= 2e-3 * lr, err.mean()
        assert err.max() <= 5e-2 * lr, err.max()


def test_cast_weights_keeps_batchnorm_float32():
    """`cast_weights` to bf16 keeps every BatchNorm leaf (bn1..bn3,
    down_bn: the running variance among them) float32, casts the
    convolutions (channels-last) and the pool's projections, and the bf16
    tower equals the tower on those cast weights with its BatchNorms
    folded in float32 from the float32 statistics."""
    cfg = tm.CLIPConfig(**TINY2)
    vis = tm.clip_init(torch.Generator().manual_seed(6), cfg)["visual"]
    rs = np.random.RandomState(7)
    for bn in ([vis["stem"]["bn1"]]
               + [b[k] for st in vis["layers"] for b in st
                  for k in b if "bn" in k]):
        bn.update({k: torch.tensor(v) for k, v in
                   _bn_params(rs, bn["g"].shape[0]).items()})
    cast = tm.cast_weights(vis, torch.bfloat16)
    blk = cast["layers"][1][0]
    assert blk["down_bn"]["v"].dtype == torch.float32
    assert blk["bn2"]["m"].dtype == torch.float32
    assert blk["conv2_w"].dtype == torch.bfloat16
    assert blk["conv2_w"].is_contiguous(memory_format=torch.channels_last)
    assert cast["attnpool"]["q_w"].dtype == torch.bfloat16
    x = torch.tensor(rs.randn(2, 3, 64, 64).astype(np.float32))
    got = tm.encode_image({"visual": cast}, cfg, x, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    p = cast["stem"]["bn1"]
    y = torch.randn((1, cfg.vision_width // 2, 4, 4)).to(torch.bfloat16)
    inv = torch.rsqrt(p["v"] + 1e-5)
    want = (y * (p["g"] * inv).to(torch.bfloat16)[:, None, None]
            + (p["b"] - p["m"] * p["g"] * inv).to(torch.bfloat16)[:, None,
                                                                  None])
    assert torch.equal(tm._bn(y, p), want)
