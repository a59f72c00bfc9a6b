"""Three train steps of the port (aphantasia_torch/step.py) against the JAX
package's `build_train_step`, from the same start (tiny CLIP, converted
weights, same spectrum params, same prompt embeddings) with the JAX step's
own random draws fed to the port.

Float32 on the CPU.  Tolerances: losses 1e-4 relative; params 2e-3 of the
learning rate (0.05) in the mean and 5e-2 of it at the worst element.  The
default optimizer (adam_custom, b1 = 0) moves every element by about
lr * g / |g|, so an element whose gradient is near zero amplifies float32
noise in its own update; the mean holds the whole update tight.  The
`fast` transform warps in bf16, so that case is held per step instead
(see its docstring).
"""
import numpy as np
import jax
import jax.numpy as jnp
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

CFG_KW = dict(name="tiny", embed_dim=32, image_resolution=32,
              vision_layers=2, vision_width=128, vision_patch_size=8,
              transformer_width=64, transformer_heads=2, transformer_layers=2)


def _setup(kw, h=48, w=64, s=4, res=32, tkw=None):
    cfg_kw = dict(CFG_KW, image_resolution=res)
    jcfg, tcfg = jm.CLIPConfig(**cfg_kw), tm.CLIPConfig(**cfg_kw)
    jclip = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    p0 = (0.07 * np.random.RandomState(1).randn(1, 3, h, w // 2 + 1, 2)
          ).astype(np.float32)
    embs = np.random.RandomState(2).randn(2, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    jset = jstep.StepSettings(sim="mix", clip_dtype=jnp.float32, **kw)
    tset = tstep.StepSettings(sim="mix", clip_dtype=torch.float32, **kw,
                              **(tkw or {}))
    jsam = JSampler((h, w), s, res, "uniform", 0.4)
    tsam = CutoutSampler((h, w), s, res, "uniform", 0.4)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jclip=jclip,
        tclip=clip_params_from_numpy(tree_np(jclip)), p0=p0, jset=jset,
        tset=tset, jsam=jsam, tsam=tsam,
        jpar=JFFT((h, w), 1.5, 1.8), tpar=FFTParameterizer((h, w), 1.5, 1.8),
        jprompts=((jnp.asarray(embs), jnp.asarray(wts), jnp.float32(-1.0)),),
        tprompts=((torch.tensor(embs), torch.tensor(wts), -1.0),))


def test_fast_transform_loss_and_grad_match_jax():
    """The `fast` pipeline warps in bf16 in both packages, and Adam with
    b1 = 0 turns the bf16 noise of near-zero gradient elements into
    full-size updates, so free-running trajectories part.  This case holds
    the loss (2e-3 relative) and the gradient (2e-2 relative L2 error) at
    each of 3 steps of the JAX trajectory instead."""
    c = _setup(dict(transform="fast"))
    s = c["jsam"].count
    jloss = jstep.build_loss_fn(c["jpar"], c["jsam"], c["jcfg"], c["jset"])
    tloss = tstep.build_loss_fn(c["tpar"], c["tsam"], c["tcfg"], c["tset"])
    jopt = jo.build_optimizer("adam_custom", 0.05, 3)
    jtrain = jstep.build_train_step(c["jpar"], c["jsam"], c["jcfg"],
                                    c["jset"], jopt, jit=False)
    jp = jnp.asarray(c["p0"])
    js = jopt.init(jp)
    jprev = jnp.zeros((s, 32))
    key = jax.random.PRNGKey(3)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        (lj, _), gj = jax.value_and_grad(jloss, has_aux=True)(
            jp, c["jclip"], None, None, c["jprompts"], jprev, k, i)
        x = torch.tensor(np.array(jp), requires_grad=True)
        draws = jax_step_draws(k, c["jsam"], c["jset"], c["p0"].shape)
        lt, _ = tloss(x, c["tclip"], None, None, c["tprompts"],
                      torch.tensor(np.array(jprev)), draws, i)
        (gt,) = torch.autograd.grad(lt, x)
        np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-3)
        gj = np.asarray(gj)
        assert (np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)) <= 2e-2
        jp, js, jprev, _ = jtrain(jp, js, jprev, c["jclip"], None, None,
                                  c["jprompts"], k, jnp.int32(i))


def test_mixed_perspective_step_matches_jax(monkeypatch):
    """One step with persp="mixed" against the JAX step built under
    APHANTASIA_EXACT_PERSP=mixed (its get_transform reads the variable when
    the loss is built), on the JAX step's draws.  The cutouts are 40 px,
    not a multiple of 16, so the JAX exact warp runs its plain reference
    instead of the Pallas kernel in interpret mode.  The rotation warps in
    bf16 on both sides, so the `fast` case's tolerances hold: loss 2e-3
    relative, gradient 2e-2 relative L2 error."""
    from aphantasia_tpu.ops import augs as jaugs
    monkeypatch.setenv("APHANTASIA_EXACT_PERSP", "mixed")
    assert jaugs.get_transform("fast") is jaugs.transforms_fast_mixed
    c = _setup(dict(transform="fast"), s=6, res=40, tkw=dict(persp="mixed"))
    s = c["jsam"].count
    jloss = jstep.build_loss_fn(c["jpar"], c["jsam"], c["jcfg"], c["jset"])
    tloss = tstep.build_loss_fn(c["tpar"], c["tsam"], c["tcfg"], c["tset"])
    key = jax.random.PRNGKey(5)
    jprev = jnp.zeros((s, 32))
    vg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                 static_argnums=(2, 3, 7))
    (lj, _), gj = vg(jnp.asarray(c["p0"]), c["jclip"], None, None,
                     c["jprompts"], jprev, key, 0)
    draws = jax_step_draws(key, c["jsam"], c["jset"], c["p0"].shape)
    assert int((draws.cuts.aug.endpoints.reshape(s, -1)
                != draws.cuts.aug.endpoints[:1].reshape(1, -1)).any(1).sum())
    x = torch.tensor(c["p0"], requires_grad=True)
    lt, _ = tloss(x, c["tclip"], None, None, c["tprompts"],
                  torch.zeros((s, 32)), draws, 0)
    (gt,) = torch.autograd.grad(lt, x)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-3)
    gj = np.asarray(gj)
    assert (np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)) <= 2e-2


def test_step_under_the_window_and_ln_switches_matches_jax(monkeypatch):
    """One step with APHANTASIA_WIN_CUTOUT=1 and APHANTASIA_PALLAS_LN=1 in
    both packages, on the JAX step's draws: 61 cutouts (61 x 17 = 1037
    flat rows, so the port's block LayerNorms take the fused function)
    through the windowed forward and its dense transpose (the JAX package's
    Pallas windowed kernel in interpret mode).  The `none` transform keeps
    the step float32: loss 1e-4 relative, gradient 1e-3 relative L2
    error."""
    from aphantasia_torch.ops import ln as tln
    calls = []
    fused = tln.layer_norm_fused

    def counted(*a, **k):
        calls.append(a[0].shape)
        return fused(*a, **k)
    monkeypatch.setattr(tln, "layer_norm_fused", counted)
    monkeypatch.setenv("APHANTASIA_WIN_CUTOUT", "1")
    monkeypatch.setenv("APHANTASIA_PALLAS_LN", "1")
    monkeypatch.setattr(jm, "_PALLAS_LN", True)
    c = _setup(dict(transform="none"), s=61)
    s = c["jsam"].count
    assert c["jsam"]._win_eligible(jnp.zeros((3, 48, 64)), jnp.float32)
    assert c["tsam"]._win_eligible(torch.zeros((3, 48, 64)), torch.float32)
    jloss = jstep.build_loss_fn(c["jpar"], c["jsam"], c["jcfg"], c["jset"])
    tloss = tstep.build_loss_fn(c["tpar"], c["tsam"], c["tcfg"], c["tset"])
    key = jax.random.PRNGKey(8)
    jprev = jnp.zeros((s, 32))
    vg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                 static_argnums=(2, 3, 7))
    (lj, _), gj = vg(jnp.asarray(c["p0"]), c["jclip"], None, None,
                     c["jprompts"], jprev, key, 0)
    draws = jax_step_draws(key, c["jsam"], c["jset"], c["p0"].shape)
    x = torch.tensor(c["p0"], requires_grad=True)
    lt, _ = tloss(x, c["tclip"], None, None, c["tprompts"],
                  torch.zeros((s, 32)), draws, 0)
    (gt,) = torch.autograd.grad(lt, x)
    assert calls == [(61 * 17, 128)] * 4
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-4)
    gj = np.asarray(gj)
    assert (np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)) <= 1e-3


def test_three_steps_match_jax():
    """All float32 loss terms (noise, sharpness, expand, enforce) with the
    `none` transform, three free-running steps on both sides."""
    lr = 0.05
    c = _setup(dict(transform="none", noise=0.1, sharp=0.2, expand=0.5,
                    enforce=0.3))
    s = c["jsam"].count
    jopt = jo.build_optimizer("adam_custom", lr, 3)
    jtrain = jstep.build_train_step(c["jpar"], c["jsam"], c["jcfg"],
                                    c["jset"], jopt, jit=False)
    topt = to.build_optimizer("adam_custom", lr, 3)
    ttrain = tstep.build_train_step(c["tpar"], c["tsam"], c["tcfg"],
                                    c["tset"], topt)
    jp = jnp.asarray(c["p0"])
    js = jopt.init(jp)
    jprev = jnp.zeros((s, 32))
    tp = fft_params_from_numpy(c["p0"])
    ts = topt.init(tp)
    tprev = torch.zeros((s, 32))
    key = jax.random.PRNGKey(3)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        jp, js, jprev, jloss = jtrain(jp, js, jprev, c["jclip"], None, None,
                                      c["jprompts"], k, jnp.int32(i))
        draws = jax_step_draws(k, c["jsam"], c["jset"], c["p0"].shape)
        tp, ts, tprev, tloss = ttrain(tp, ts, tprev, c["tclip"], None, None,
                                      c["tprompts"], draws, i)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4,
                                   atol=1e-4)
    err = np.abs(tp.numpy() - np.asarray(jp))
    assert err.mean() <= 2e-3 * lr, err.mean()
    assert err.max() <= 5e-2 * lr, err.max()
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), atol=1e-3)


def test_draw_fn_shapes():
    g = torch.Generator().manual_seed(0)
    sam = CutoutSampler((48, 64), 5, 32)
    sett = tstep.StepSettings(transform="fast", noise=0.2, enforce=0.1)
    d = tstep.build_draw_fn(sam, sett, (1, 3, 48, 33, 2))(g)
    assert d.shift.shape == (1, 1, 48, 33, 1)
    assert d.cuts.boxes.csize.shape == (5,)
    assert d.cuts.aug.endpoints.shape == (5, 4, 2)
    assert d.cuts2 is not None
    moved = tstep.to_device(d, "cpu")
    assert type(moved.cuts.aug) is type(d.cuts.aug)


def test_unported_terms_raise():
    """The aesthetic and LPIPS-sync terms, which raised until they were
    ported, against the JAX step: three free-running steps with --aest
    (a head on the 32-wide embeddings) and --sync (random VGG16 weights
    carried across, a 24x32 target for the 48x64 frame, total_steps 5 so
    the progress weight falls from 1 to 0.6), the `none` transform and
    the JAX step's draws; step_i a device tensor on the port's side.  The
    first-test tolerances: losses 1e-4 relative, params 2e-3 / 5e-2 of
    the learning rate.  Without the head and the bundle both terms are
    absent, as in JAX: the loss equals the plain loss."""
    from aphantasia_tpu.models.lpips import lpips_init
    from aphantasia_torch.convert import (aesthetic_params_from_numpy,
                                          lpips_params_from_numpy)
    lr = 0.05
    kw = dict(transform="none", aest=2.0, sync=0.5, total_steps=5)
    c = _setup(kw)
    s = c["jsam"].count
    rs = np.random.RandomState(6)
    head = {"w": (0.1 * rs.randn(32, 1)).astype(np.float32),
            "b": np.asarray([0.2], np.float32)}
    lp = tree_np(lpips_init(jax.random.PRNGKey(1)))
    img_in = rs.rand(1, 3, 24, 32).astype(np.float32)
    jbundle = (jax.tree.map(jnp.asarray, lp), jnp.asarray(img_in))
    tbundle = (lpips_params_from_numpy(lp), torch.tensor(img_in))
    jhead = jax.tree.map(jnp.asarray, head)
    thead = aesthetic_params_from_numpy(head)
    jopt = jo.build_optimizer("adam_custom", lr, 3)
    topt = to.build_optimizer("adam_custom", lr, 3)
    jtrain = jstep.build_train_step(c["jpar"], c["jsam"], c["jcfg"],
                                    c["jset"], jopt)
    ttrain = tstep.build_train_step(c["tpar"], c["tsam"], c["tcfg"],
                                    c["tset"], topt)
    jp = jnp.asarray(c["p0"])
    js, jprev = jopt.init(jp), jnp.zeros((s, 32))
    tp = fft_params_from_numpy(c["p0"])
    ts, tprev = topt.init(tp), torch.zeros((s, 32))
    key = jax.random.PRNGKey(12)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        jp, js, jprev, jl = jtrain(jp, js, jprev, c["jclip"], jhead, jbundle,
                                   c["jprompts"], k, jnp.int32(i + 1))
        draws = jax_step_draws(k, c["jsam"], c["jset"], c["p0"].shape)
        tp, ts, tprev, tl = ttrain(
            tp, ts, tprev, c["tclip"], thead, tbundle, c["tprompts"], draws,
            torch.tensor(i + 1, dtype=torch.int32))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4,
                                   atol=1e-4)
    err = np.abs(tp.numpy() - np.asarray(jp))
    assert err.mean() <= 2e-3 * lr, err.mean()
    assert err.max() <= 5e-2 * lr, err.max()
    plain = tstep.build_loss_fn(c["tpar"], c["tsam"], c["tcfg"],
                                tstep.StepSettings(transform="none"))
    terms = tstep.build_loss_fn(c["tpar"], c["tsam"], c["tcfg"], c["tset"])
    args = (c["tprompts"], tprev, draws, 0)
    base = plain(tp, c["tclip"], None, None, *args)[0]
    assert torch.equal(terms(tp, c["tclip"], None, None, *args)[0], base)
    assert terms(tp, c["tclip"], thead, tbundle, *args)[0] != base


def test_render_is_uint8_frame():
    par = FFTParameterizer((24, 32))
    frame = tstep.build_render(par)(par.init(torch.Generator().manual_seed(0)))
    assert frame.shape == (24, 32, 3) and frame.dtype == torch.uint8
