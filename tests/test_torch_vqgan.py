"""The port's VQGAN decoder and clip_vqgan CLI (aphantasia_torch/
models/vqgan.py, cli/clip_vqgan.py) against the JAX package on the CPU:
`vqgan_decode` forward and gradient on f16-like and gumbel-like tiny
decoders with their attentions (block i, then attention i, as the JAX
function orders them), `convert_taming` on a written state dict through
both packages (and a Lightning-style `.ckpt` through the port's
restricted read), `.pt` latents across both `io/checkpoint` modules, a
two-call VQGAN frame loop on JAX's draws, and the CLI end to end
(`--device cpu`) with JAX's file names.

Float32 (the port's "auto" dtype on the CPU).  Tolerances at each test."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models import vqgan as jv
from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import clip_vqgan as tcli
from aphantasia_torch.cli.common import build_prompt_groups
from aphantasia_torch.convert import (clip_params_from_numpy,
                                      vqgan_params_from_numpy)
from aphantasia_torch.models import vqgan as tv
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler

from _torch_parity import jax_step_draws, tree_np

# f16-like: three levels, attentions at the coarsest, one res block + 1;
# gumbel-like: two levels, two res blocks + 1, so three attentions
CFGS = {"f16": dict(name="tiny16", z_channels=8, ch=32, ch_mult=(1, 1, 2),
                    num_res_blocks=1, attn_resolutions=(16,)),
        "gumbel": dict(name="tiny8", z_channels=8, ch=32, ch_mult=(1, 2),
                       num_res_blocks=2, attn_resolutions=(32,))}
TINY_B32 = dict(name="ViT-B/32", embed_dim=512, image_resolution=224,
                vision_layers=1, vision_width=64, vision_patch_size=32,
                transformer_width=64, transformer_heads=1,
                transformer_layers=1)


def _decoder(kind, seed=0):
    jcfg, tcfg = jv.VQGANConfig(**CFGS[kind]), tv.VQGANConfig(**CFGS[kind])
    jp = jv.vqgan_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, vqgan_params_from_numpy(tree_np(jp))


@pytest.mark.parametrize("kind,post_quant", [("f16", False),
                                             ("gumbel", True)])
def test_decode_and_gradient_match_jax(kind, post_quant):
    """The decode of a random latent (0.5 * randn: some pixels saturate)
    and the gradient of sum(img * r) w.r.t. the latent: forward within
    1e-5 absolute, gradient within 1e-4 relative L2; the decoder gets no
    gradient."""
    jcfg, tcfg, jp, tp = _decoder(kind)
    assert len(tp["up"][-1]["attns"]) == tcfg.num_res_blocks + 1
    f = jcfg.f
    z = (0.5 * np.random.RandomState(1).randn(1, 8, 24 // f, 32 // f)
         ).astype(np.float32)
    r = np.random.RandomState(2).randn(1, 3, 24, 32).astype(np.float32)

    def jfn(zz):
        return jv.vqgan_decode(jp, jcfg, zz, use_post_quant=post_quant)
    want, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(z))
    want = np.asarray(want)
    jg = np.asarray(vjp(jnp.asarray(r))[0])
    x = torch.tensor(z, requires_grad=True)
    img = tv.vqgan_decode(tp, tcfg, x, use_post_quant=post_quant)
    (tg,) = torch.autograd.grad((img * torch.tensor(r)).sum(), x)
    assert img.dtype == torch.float32 and img.shape == (1, 3, 24, 32)
    assert 0 < (want == 0).mean() + (want == 1).mean() < 0.9
    np.testing.assert_allclose(img.detach().numpy(), want, atol=1e-5, rtol=0)
    assert np.linalg.norm(tg.numpy() - jg) <= 1e-4 * np.linalg.norm(jg)
    assert not any(t.requires_grad for t in _leaves(tp).values())


def _leaves(tree, path=""):
    """{path: tensor} of a decoder tree (dict keys in any order)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{path}/{i}").items()}
    return {path: tree}


def test_parameterizer_dtypes(monkeypatch):
    """"auto" is float32 on the CPU and bf16 on the card unless
    APHANTASIA_DECODE_F32=1; the decoder is cast once a dtype, its
    GroupNorm affines kept float32; a bf16 decode stays within the JAX
    package's bf16 bound (mean |diff| / std < 0.05, corr > 0.995;
    tests/test_vqgan.py) of the float32 one."""
    monkeypatch.delenv("APHANTASIA_DECODE_F32", raising=False)
    assert tv.decode_dtype(torch.device("cpu")) == torch.float32
    assert tv.decode_dtype(torch.device("cuda")) == torch.bfloat16
    monkeypatch.setenv("APHANTASIA_DECODE_F32", "1")
    assert tv.decode_dtype(torch.device("cuda")) == torch.float32
    _, tcfg, _, tp = _decoder("gumbel")
    par = tv.VQGANParameterizer((24, 32), tcfg, tp)
    z = par.init(torch.Generator().manual_seed(3))
    assert z.shape == (1, 8, 12, 16)
    f32 = par.image(z)
    assert par.decoder(torch.float32) is par.decoder(torch.float32)
    dec = par.decoder(torch.bfloat16)
    assert dec["conv_in"]["w"].dtype == torch.bfloat16
    assert dec["norm_out"]["g"].dtype == torch.float32
    assert dec["up"][1]["attns"][0]["norm"]["b"].dtype == torch.float32
    bf = tv.VQGANParameterizer((24, 32), tcfg, tp, torch.bfloat16).image(z)
    assert bf.dtype == torch.float32
    f32, bf = f32.numpy(), bf.numpy()
    assert np.abs(bf - f32).mean() / (f32.std() + 1e-9) < 0.05
    assert np.corrcoef(bf.ravel(), f32.ravel())[0, 1] > 0.995


def _taming_sd(cfg, seed=0):
    """A taming decoder state dict (OIHW, its key names) for `cfg`."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(prefix, cin, cout, k):
        sd[prefix + ".weight"] = torch.tensor(
            rs.randn(cout, cin, k, k).astype(np.float32) * 0.05)
        sd[prefix + ".bias"] = torch.tensor(
            rs.randn(cout).astype(np.float32) * 0.01)

    def norm(prefix, c):
        sd[prefix + ".weight"] = torch.tensor(
            (1.0 + 0.1 * rs.randn(c)).astype(np.float32))
        sd[prefix + ".bias"] = torch.tensor(
            rs.randn(c).astype(np.float32) * 0.01)

    def res(prefix, cin, cout):
        norm(prefix + ".norm1", cin)
        conv(prefix + ".conv1", cin, cout, 3)
        norm(prefix + ".norm2", cout)
        conv(prefix + ".conv2", cout, cout, 3)
        if cin != cout:
            conv(prefix + ".nin_shortcut", cin, cout, 1)

    def attn(prefix, c):
        norm(prefix + ".norm", c)
        for nm in ("q", "k", "v", "proj_out"):
            conv(prefix + "." + nm, c, c, 1)

    z, block_in = cfg.z_channels, cfg.ch * cfg.ch_mult[-1]
    conv("post_quant_conv", z, z, 1)
    conv("decoder.conv_in", z, block_in, 3)
    res("decoder.mid.block_1", block_in, block_in)
    attn("decoder.mid.attn_1", block_in)
    res("decoder.mid.block_2", block_in, block_in)
    cur = block_in
    for level in reversed(range(len(cfg.ch_mult))):
        cout = cfg.ch * cfg.ch_mult[level]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{level}.block.{j}", cur, cout)
            cur = cout
            if level == len(cfg.ch_mult) - 1:
                attn(f"decoder.up.{level}.attn.{j}", cur)
        if level:
            conv(f"decoder.up.{level}.upsample.conv", cur, cur, 3)
    norm("decoder.norm_out", cur)
    conv("decoder.conv_out", cur, 3, 3)
    sd["quantize.embedding.weight"] = torch.zeros((16, z))   # not read
    return sd


class _Callback:
    """A class that a Lightning checkpoint pickles by reference; its state
    setter records any call (the restricted read must make none)."""
    calls: list = []

    def __setstate__(self, state):
        _Callback.calls.append(state)


@pytest.mark.parametrize("kind", ["f16", "gumbel"])
def test_convert_taming_matches_jax(tmp_path, kind):
    """A written state dict through both packages' `convert_taming`: the
    port's tree equals JAX's (HWIO -> OIHW) leaf for leaf; the decodes
    agree within 1e-5.  A Lightning-style `.ckpt` ({"state_dict": ...,
    "callbacks": {class: object}}), which `weights_only` refuses, reads
    through the restricted read to the same tree, running none of its
    classes' code."""
    jcfg, tcfg = jv.VQGANConfig(**CFGS[kind]), tv.VQGANConfig(**CFGS[kind])
    sd = _taming_sd(tcfg)
    path = str(tmp_path / "vqgan.pt")
    torch.save(sd, path)
    jp = jv.convert_taming(path, jcfg)
    tp = tv.convert_taming(path, tcfg)
    want = vqgan_params_from_numpy(tree_np(jp))
    got, want = _leaves(tp), _leaves(want)
    assert got.keys() == want.keys() and len(got) > 40
    assert all(torch.equal(got[k], want[k]) for k in got)
    z = (0.3 * np.random.RandomState(4).randn(1, 8, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tv.vqgan_decode(tp, tcfg, torch.tensor(z)).numpy(),
        np.asarray(jv.vqgan_decode(jp, jcfg, jnp.asarray(z))), atol=1e-5)
    ckpt = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": sd, "global_step": 7,
                "callbacks": {_Callback: _Callback()}}, ckpt)
    import pickle
    with pytest.raises(pickle.UnpicklingError):
        torch.load(ckpt, weights_only=True)
    tp2 = tv.convert_taming(ckpt, tcfg)
    got2 = _leaves(tp2)
    assert got2.keys() == got.keys()
    assert all(torch.equal(got2[k], got[k]) for k in got)
    assert _Callback.calls == []


def test_latent_pt_files_cross_the_packages(tmp_path):
    """A latent saved by either package's `save_pt` reads back equal
    through the other's `load_pt` (a bare tensor)."""
    from aphantasia_tpu.io import checkpoint as jck
    from aphantasia_torch.io import checkpoint as tck
    z = np.random.RandomState(5).randn(1, 8, 3, 4).astype(np.float32)
    tck.save_pt(str(tmp_path / "t.pt"), torch.tensor(z))
    jck.save_pt(str(tmp_path / "j.pt"), z)
    for path in ("t.pt", "j.pt"):
        for load in (jck.load_pt, tck.load_pt):
            got = load(str(tmp_path / path))
            got = got[0] if isinstance(got, list) else got
            np.testing.assert_array_equal(np.asarray(got), z)


def test_vqgan_frame_loop_matches_jax():
    """Two calls of two one-step groups (`build_train_loop_frames`,
    opt_step 1, as clip_vqgan runs it) on the f16-like decoder, adam_custom
    at 0.1, sim mix, the float32 `none` transform, JAX's draws: losses
    within 1e-4 relative, the latent within 2e-3 of the learning rate in
    the mean and 5e-2 at the worst element (Adam with b1 = 0 turns float
    noise in a near-zero gradient element into a full update).  The
    frames: the first within one level of JAX's, and each call's last
    (rendered from the latent the call returns) within one level of
    JAX's render of that latent (later frames of the free-running
    trajectories part by the latent's envelope, which the decoder
    amplifies)."""
    h, w, s, lr = 24, 32, 3, 0.1
    jcfg, tcfg, jdec, tdec = _decoder("f16")
    ckw = dict(name="tiny", embed_dim=32, image_resolution=32,
               vision_layers=1, vision_width=64, vision_patch_size=8,
               transformer_width=64, transformer_heads=1,
               transformer_layers=1)
    jccfg, tccfg = jm.CLIPConfig(**ckw), tm.CLIPConfig(**ckw)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jccfg)
    tclip = clip_params_from_numpy(tree_np(jclip))
    kw = dict(sim="mix", transform="none", total_steps=4)
    jset = jstep.StepSettings(clip_dtype=jnp.float32, **kw)
    tset = tstep.StepSettings(clip_dtype=torch.float32, **kw)
    jsam = JSampler((h, w), s, 32, "uniform", 0.4)
    tsam = CutoutSampler((h, w), s, 32, "uniform", 0.4)
    jpar = jv.VQGANParameterizer((h, w), jcfg, jdec)
    tpar = tv.VQGANParameterizer((h, w), tcfg, tdec)
    emb = np.random.RandomState(6).randn(2, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    jprompts = ((jnp.asarray(emb), jnp.asarray(wts), jnp.float32(-1.0)),)
    tprompts = build_prompt_groups([(torch.tensor(emb), torch.tensor(wts),
                                     -1.0)])
    jopt = jo.build_optimizer("adam_custom", lr)
    topt = to.build_optimizer("adam_custom", lr)
    z0 = np.asarray(jpar.init(jax.random.PRNGKey(7)))
    jloop = jstep.build_train_loop_frames(jpar, jsam, jccfg, jset, jopt, 1, 2)
    tloop = tstep.build_train_loop_frames(tpar, tsam, tccfg, tset, topt, 1, 2)
    js = (jnp.asarray(z0), jopt.init(jnp.asarray(z0)), jnp.zeros((s, 32)))
    ts = (torch.tensor(z0), topt.init(torch.tensor(z0)), torch.zeros((s, 32)))
    key = jax.random.PRNGKey(8)
    for call in range(2):
        *js, jf, jl = jloop(*js, jclip, None, None, jprompts, key,
                            jnp.int32(2 * call))
        *ts, tf, tl = tloop(*ts, tclip, None, None, tprompts,
                            lambda g: jax_step_draws(jax.random.fold_in(
                                key, g), jsam, jset, None), 2 * call)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-6)
        if call == 0:
            assert np.abs(tf[0].numpy().astype(int)
                          - np.asarray(jf[0])).max() <= 1
        jimg = jpar.image(jnp.asarray(ts[0].numpy()))[0].transpose(1, 2, 0)
        jlast = np.asarray(jnp.clip(jimg, 0, 1) * 255.0 + 0.5).astype(int)
        assert np.abs(tf[-1].numpy().astype(int) - jlast).max() <= 1
        err = np.abs(ts[0].numpy() - np.asarray(js[0]))
        assert err.mean() <= 2e-3 * lr and err.max() <= 5e-2 * lr


@pytest.fixture
def tiny(monkeypatch):
    """ViT-B/32 cut to one block of width 64 and the f16-like decoder in
    place of imagenet_f16_16384, in both packages."""
    monkeypatch.setitem(tm.CLIP_CONFIGS, "ViT-B/32", tm.CLIPConfig(**TINY_B32))
    monkeypatch.setitem(jm.CLIP_CONFIGS, "ViT-B/32", jm.CLIPConfig(**TINY_B32))
    monkeypatch.setitem(tv.VQGAN_CONFIGS, "imagenet_f16_16384",
                        tv.VQGANConfig(**CFGS["f16"]))
    monkeypatch.setitem(jv.VQGAN_CONFIGS, "imagenet_f16_16384",
                        jv.VQGANConfig(**CFGS["f16"]))
    monkeypatch.delenv("APHANTASIA_VQGAN_PT", raising=False)


def _listing(root):
    return {os.path.relpath(os.path.join(dp, f), root)
            for dp, _, fs in os.walk(root) for f in fs}


def test_cli_outputs_and_names_equal_jax(tmp_path, monkeypatch, tiny):
    """The JAX CLI and the port's on the same flags (a text, a style and a
    subtract prompt, 4 steps, a size the stride of 4 snaps from 50x38 to
    48x36, --save_pt): the same files; the budget 40 x 0.95 x 0.75 x 0.75;
    the latent's `.pt` read by the JAX package."""
    from aphantasia_tpu.cli import clip_vqgan as jcli
    from aphantasia_tpu.io.checkpoint import load_pt
    from aphantasia_tpu.parallel import multihost
    monkeypatch.setattr(jcli, "apply_platform", lambda: None)
    monkeypatch.setattr(multihost, "init_fleet", lambda spec=None: (0, 1))
    argv = ["-t", "a test", "-t2", "style", "-t0", "not this", "--size",
            "50-38", "--steps", "4", "--samples", "40", "-nv", "--save_pt"]
    jcli.main(argv + ["--out_dir", str(tmp_path / "j")])
    res = tcli.run(tcli.get_args(argv + ["--out_dir", str(tmp_path / "t"),
                                        "--device", "cpu"]))
    name = "a_test-style-off-not_this-vq"
    got = _listing(tmp_path / "t")
    assert got == _listing(tmp_path / "j") == {
        f"{name}/000{i}.jpg" for i in range(4)} | {
        f"{name}/config.txt", f"{name}.mp4", f"{name}-4.jpg", f"{name}.pt"}
    assert res.out_name == name and res.samples == 21
    assert tuple(res.params.shape) == (1, 8, 9, 12)
    assert [round(g[2].item(), 3) for g in res.loop.bufs.consts[0][3]] == [
        -1.0, -1.0, 1.0]
    assert all(np.isfinite(res.losses)) and len(res.losses) == 4
    np.testing.assert_array_equal(load_pt(str(tmp_path / "t" / f"{name}.pt")),
                                  res.params.numpy())


def test_cli_image_prompt_resume_and_weights(tmp_path, tiny):
    """An image prompt (weight -weight_img), --vqgan_weights from a written
    taming state dict, --pallas, then --resume from the saved latent."""
    from aphantasia_torch.io.media import img_save
    src = str(tmp_path / "src.png")
    img_save(src, np.random.RandomState(9).rand(40, 56, 3))
    ckpt = str(tmp_path / "vq.pt")
    torch.save(_taming_sd(tv.VQGANConfig(**CFGS["f16"])), ckpt)
    out = str(tmp_path / "o")
    base = ["--size", "48-32", "--steps", "2", "--samples", "8", "-nv",
            "--device", "cpu", "--out_dir", out]
    res = tcli.run(tcli.get_args(["-i", src, "-wi", "0.7", "--vqgan_weights",
                                  ckpt, "--pallas", "--save_pt"] + base))
    assert res.out_name == "src-vq" and res.samples == 7
    assert res.loop.bufs.consts[0][3][0][2].item() == pytest.approx(-0.7)
    assert torch.equal(res.par.decoder_params["conv_in"]["w"],
                       torch.load(ckpt)["decoder.conv_in.weight"])
    pt = os.path.join(out, "src-vq.pt")
    res2 = tcli.run(tcli.get_args(["-t", "x", "-r", pt] + base))
    assert all(np.isfinite(res2.losses))
    assert torch.equal(res2.loop.bufs.params, res2.params)


def _no_fleet(monkeypatch):
    """No fleet resolved and no APHANTASIA_FLEET, undone after the test."""
    from aphantasia_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_FLEET", None)
    monkeypatch.setattr(multihost, "_COORD", None)
    monkeypatch.delenv("APHANTASIA_FLEET", raising=False)
    return multihost


@pytest.mark.parametrize("flags", [["--mesh", "dcn"], ["--fleet", "0/2"]])
def test_unported_flags_raise(tmp_path, monkeypatch, tiny, flags):
    """--mesh and --fleet, which raised until they were ported, run:
    --mesh dcn (a data mesh of one rank in this process, its collectives
    included) gives the dense run's losses and latent bit for bit;
    --fleet 0/2 runs the whole job on this host."""
    mh = _no_fleet(monkeypatch)
    base = ["-t", "x", "--device", "cpu", "--steps", "1", "--samples", "2",
            "--size", "48-32", "-nv"]
    res = tcli.run(tcli.get_args(base + ["--out_dir", str(tmp_path / "m")]
                                 + flags))
    if flags[0] == "--fleet":
        assert mh.fleet_info() == (0, 2) and all(np.isfinite(res.losses))
        return
    dense = tcli.run(tcli.get_args(base + ["--out_dir", str(tmp_path / "d")]))
    assert res.losses == dense.losses
    assert torch.equal(res.params, dense.params)
