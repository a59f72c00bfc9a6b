"""The port's wavelet generator (aphantasia_torch/params/wavelets.py and
params/dwt.py, `--dwt`) against the JAX package's, on the CPU, from the
same numpy-seeded inputs.

Tolerances: the filter banks exactly (the same numpy construction); the
transforms and the decode in float32, 1e-5 (value and gradient; filters
up to 62 taps summed in other orders than XLA's convolutions); the train
step on a DWT pyramid as tests/test_torch_step.py holds the FFT step:
losses 1e-4 relative, params 2e-3 of the learning rate in the mean and
5e-2 of it at the worst element.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.params import dwt as jd
from aphantasia_tpu.params import wavelets as jw
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.convert import dwt_params_from_numpy
from aphantasia_torch.ops import optim as to
from aphantasia_torch.params import dwt as td
from aphantasia_torch.params import wavelets as tw

from _torch_parity import jax_step_draws
from test_torch_step import _setup

WAVES = ["haar", "db2", "db4", "sym4", "coif2", "dmey"]


@pytest.mark.parametrize("wave", WAVES)
def test_wavelet_filters_equal_jax(wave):
    for a, b in zip(tw.wavelet_filters(wave), jw.wavelet_filters(wave)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for n in (1, 2, 33, 48, 720, 1280):
        assert tw.dwt_max_level(n) == jw.dwt_max_level(n)


@pytest.mark.parametrize("hw", [(33, 47), (64, 48)])
@pytest.mark.parametrize("wave", ["haar", "db2", "coif2", "dmey"])
def test_wavedec_and_waverec_match_jax(wave, hw):
    """Two levels down and back: every subband and the reconstruction
    within 1e-5 of the JAX transforms; the shapes are `dwt_shapes`."""
    x = np.random.RandomState(0).randn(1, 3, *hw).astype(np.float32)
    jl, jh = jd.wavedec2(jnp.asarray(x), wave, 2)
    tl, th = td.wavedec2(torch.tensor(x), wave, 2)
    assert ([tuple(tl.shape)] + [tuple(h.shape) for h in th]
            == td.dwt_shapes(hw, wave, 2) == jd.dwt_shapes(hw, wave, 2))
    for a, b in zip([tl] + th, [jl] + jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    rec = td.waverec2(tl, th, wave, hw)
    np.testing.assert_allclose(rec.numpy(), np.asarray(
        jd.waverec2(jl, jh, wave, hw)), atol=1e-5)


def _pyramid(par, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in par.shapes]


@pytest.mark.parametrize("wave,hw", [("coif2", (48, 64)), ("db2", (33, 47)),
                                     ("dmey", (64, 48))])
def test_parameterizer_image_matches_jax(wave, hw):
    """`DWTParameterizer.image` (the per-level rescale, the inverse
    transform, std(ddof=1) and the colour head): value and the gradient
    of every subband within 1e-5; levels and shapes as JAX's."""
    jpar = jd.DWTParameterizer(hw, wave, 0.3, 1.8)
    tpar = td.DWTParameterizer(hw, wave, 0.3, 1.8)
    assert tpar.level == jpar.level and tpar.shapes == jpar.shapes
    pyr = _pyramid(jpar)
    co = np.random.RandomState(2).randn(1, 3, *hw).astype(np.float32)

    @jax.jit
    def image_and_grad(p, co):
        img, vjp = jax.vjp(lambda q: jpar.image(q, contrast=1.1), p)
        return img, vjp(co)[0]
    img_j, g_j = image_and_grad([jnp.asarray(p) for p in pyr],
                                jnp.asarray(co))
    tp = [torch.tensor(p, requires_grad=True) for p in pyr]
    img_t = tpar.image(tp, contrast=1.1)
    g_t = torch.autograd.grad(img_t, tp, torch.tensor(co))
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               atol=1e-5)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert td.dwt_scale(tp, 0.3) == pytest.approx(jd.dwt_scale(pyr, 0.3),
                                                  rel=1e-12)


def test_img2dwt_and_resume_match_jax(tmp_path):
    """Resume from an image (img2dwt through un_rgb; each subband within
    1e-5 of its largest entry), from a saved .pt list and from a list, as
    `resume_dwt` does in JAX; the image path also returns the image's
    size."""
    from aphantasia_torch.io.checkpoint import save_pt
    from aphantasia_torch.io.media import img_save
    src = str(tmp_path / "src.png")
    img_save(src, np.random.RandomState(3).rand(40, 56, 3))
    got, size = td.resume_dwt(src, (40, 56), "db2", 1.8)
    want, jsize = jd.resume_dwt(src, (40, 56), "db2", 1.8)
    assert tuple(size) == tuple(jsize) == (40, 56)
    assert len(got) == len(want) == 1 + jw.dwt_max_level(40)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    pt = str(tmp_path / "p.pt")
    save_pt(pt, got)
    for resume in (pt, [g.numpy() for g in got]):
        again, sz = td.resume_dwt(resume, (40, 56), "db2", 1.8)
        assert sz is None
        for a, b in zip(again, got):
            assert torch.equal(a, b)
    fresh, sz = td.resume_dwt(None, (40, 56), "db2", 1.8,
                              generator=torch.Generator().manual_seed(0))
    assert sz is None and [tuple(p.shape) for p in fresh] == \
        td.DWTParameterizer((40, 56), "db2").shapes
    with pytest.raises(FileNotFoundError):
        td.resume_dwt(os.path.join(str(tmp_path), "missing.pt"), (40, 56),
                      "db2", 1.8)


def test_dwt_steps_match_jax():
    """Three free-running train steps on a coif2 pyramid (48x64, five
    levels) with the `none` transform, sharpness, enforce and expand,
    adam_custom with --prog on the list (one count), each step on the JAX
    step's own draws: losses, params, prev_enc."""
    lr, hw = 0.05, (48, 64)
    c = _setup(dict(transform="none", sharp=0.2, expand=0.5, enforce=0.3))
    jpar = jd.DWTParameterizer(hw, "coif2", 0.3, 1.8)
    tpar = td.DWTParameterizer(hw, "coif2", 0.3, 1.8)
    pyr = _pyramid(jpar, seed=4)
    s = c["jsam"].count
    jopt = jo.build_optimizer("adam_custom", lr, 3, prog=True)
    topt = to.build_optimizer("adam_custom", lr, 3, prog=True)
    jtrain = jstep.build_train_step(jpar, c["jsam"], c["jcfg"], c["jset"],
                                    jopt)
    ttrain = tstep.build_train_step(tpar, c["tsam"], c["tcfg"], c["tset"],
                                    topt)
    jp = [jnp.asarray(p) for p in pyr]
    js, jprev = jopt.init(jp), jnp.zeros((s, 32))
    tp = dwt_params_from_numpy(pyr)
    ts, tprev = topt.init(tp), torch.zeros((s, 32))
    assert isinstance(ts.mu, list) and len(ts.mu) == len(tp)
    key = jax.random.PRNGKey(9)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        jp, js, jprev, jloss = jtrain(jp, js, jprev, c["jclip"], None, None,
                                      c["jprompts"], k, jnp.int32(i))
        draws = jax_step_draws(k, c["jsam"], c["jset"], None)
        tp, ts, tprev, tloss = ttrain(tp, ts, tprev, c["tclip"], None, None,
                                      c["tprompts"], draws, i)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4,
                                   atol=1e-4)
    assert int(ts.count) == 3
    err = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                          for a, b in zip(tp, jp)])
    assert err.mean() <= 2e-3 * lr, err.mean()
    assert err.max() <= 5e-2 * lr, err.max()
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), atol=1e-3)


def test_dwt_draws_take_no_shift_and_make_no_host_tables(monkeypatch):
    """With --noise on a pyramid the draw gives no spectrum shift (JAX
    draws none for params without a shape); after a first step, a step
    and a decode build no tensor from host data (the filters and the
    extension indices are cached per device)."""
    from test_torch_loop import _forbid_host_tables
    c = _setup(dict(transform="none", noise=0.1, expand=0.5))
    tpar = td.DWTParameterizer((48, 64), "coif2", 0.3, 1.8)
    draw = tstep.build_draw_fn(c["tsam"], c["tset"], None)
    opt = to.build_optimizer("adam_custom", 0.05, 4, prog=True)
    step = tstep.build_train_step(tpar, c["tsam"], c["tcfg"], c["tset"], opt)
    gen = torch.Generator().manual_seed(0)
    p = tpar.init(gen)
    st, prev = opt.init(p), torch.zeros((c["tsam"].count, 32))
    idx = torch.zeros((), dtype=torch.int32)
    x = torch.rand((1, 3, 48, 64))
    for i in range(2):
        if i:
            _forbid_host_tables(monkeypatch)
        d = draw(gen)
        assert d.shift is None
        p, st, prev, loss = step(p, st, prev, c["tclip"], None, None,
                                 c["tprompts"], d, idx + i)
        td.wavedec2(x, "coif2", 2)
    monkeypatch.undo()
    assert torch.isfinite(loss) and int(st.count) == 2
