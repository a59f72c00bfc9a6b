"""The port's FFT parameterizer and color head (aphantasia_torch/params)
against the JAX package on the same numpy spectra, in float32.

The JAX decode on the CPU runs its float32 matmul DFT; the port runs
torch.fft.  Tolerances: 1e-5 on decoded images (unit-std values after the
contrast normalisation) and on the sigmoid RGB, 1e-4 relative on spectra
and on the gradient into the params.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.params import color as jcolor
from aphantasia_tpu.params import fft as jfft
from aphantasia_torch.params import color as tcolor
from aphantasia_torch.params import fft as tfft


def _spec(h, w, seed=0, sd=0.07):
    return (sd * np.random.RandomState(seed).randn(1, 3, h, w // 2 + 1, 2)
            ).astype(np.float32)


@pytest.mark.parametrize("h,w", [(24, 32), (17, 23)])
def test_spectrum_roundtrip_matches_jax(h, w):
    p = _spec(h, w, 1, 1.0)
    img_j = np.asarray(jfft.spectrum_to_image(jnp.asarray(p), (h, w)))
    img_t = tfft.spectrum_to_image(torch.tensor(p), (h, w)).numpy()
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    back_j = np.asarray(jfft.image_to_spectrum(jnp.asarray(img_j), (h, w)))
    back_t = tfft.image_to_spectrum(torch.tensor(img_t), (h, w)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-4)


@pytest.mark.parametrize("decay", [1.0, 1.5])
def test_fft_scale_matches_jax(decay):
    np.testing.assert_allclose(tfft.fft_scale(24, 40, decay),
                               jfft.fft_scale(24, 40, decay), rtol=1e-6)


@pytest.mark.parametrize("with_shift,contrast", [(False, 1.0), (True, 1.1)])
def test_parameterizer_image_and_grad_match_jax(with_shift, contrast):
    h, w = 24, 40
    p = _spec(h, w, 2)
    shift = (0.3 * np.random.RandomState(3).rand(1, 1, h, w // 2 + 1, 1)
             ).astype(np.float32) if with_shift else None
    co = np.random.RandomState(4).randn(1, 3, h, w).astype(np.float32)
    jpar = jfft.FFTParameterizer((h, w), 1.5, 1.8)
    tpar = tfft.FFTParameterizer((h, w), 1.5, 1.8)

    def jf(x):
        s = None if shift is None else jnp.asarray(shift)
        return jpar.image(x, shift=s, contrast=contrast)
    out_j, vjp = jax.vjp(jf, jnp.asarray(p))
    (g_j,) = vjp(jnp.asarray(co))

    x = torch.tensor(p, requires_grad=True)
    out_t = tpar.image(x, None if shift is None else torch.tensor(shift),
                       contrast)
    (g_t,) = torch.autograd.grad(out_t, x, torch.tensor(co))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j,
                               atol=1e-4 * np.abs(g_j).max())


def test_decode_matches_jax():
    h, w = 20, 30
    p = _spec(h, w, 5)
    scale = jfft.fft_scale(h, w, 1.0)
    dj = np.asarray(jfft.fft_decode(jnp.asarray(p), jnp.asarray(scale), (h, w),
                                    contrast=1.2))
    dt = tfft.fft_decode(torch.tensor(p), torch.tensor(scale), (h, w),
                         contrast=1.2).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-5)


def test_img2fft_and_resume_match_jax(tmp_path):
    img = (np.random.RandomState(6).rand(16, 24, 3) * 255).astype(np.uint8)
    sj = np.asarray(jfft.img2fft(img, 1.5, 1.8))
    st = tfft.img2fft(img, 1.5, 1.8).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-4 * np.abs(sj).max())
    from aphantasia_torch.io.checkpoint import save_pt
    pt = os.path.join(tmp_path, "s.pt")
    p = _spec(8, 12, 7)
    save_pt(pt, [torch.tensor(p)])
    pj, _ = jfft.resume_fft(pt, sd=0.07)
    pt_, _ = tfft.resume_fft(pt, sd=0.07)
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), rtol=1e-6)


def test_fft_init_shape():
    g = torch.Generator().manual_seed(0)
    p = tfft.FFTParameterizer((24, 40)).init(g)
    assert p.shape == (1, 3, 24, 21, 2) and p.dtype == torch.float32
    assert 0.005 < p.std().item() < 0.02


def test_color_head_matches_jax():
    np.testing.assert_allclose(tcolor.color_matrix(1.8),
                               jcolor.color_matrix(1.8), rtol=1e-7)
    x = np.random.RandomState(8).randn(2, 3, 5, 6).astype(np.float32)
    for fj, ft in ((lambda a: jcolor.to_valid_rgb(a, 1.8),
                    lambda a: tcolor.to_valid_rgb(a, 1.8)),
                   (jcolor.clip_normalize, tcolor.clip_normalize),
                   (lambda a: jcolor.un_rgb(a, 1.5),
                    lambda a: tcolor.un_rgb(a, 1.5))):
        np.testing.assert_allclose(ft(torch.tensor(x)).numpy(),
                                   np.asarray(fj(jnp.asarray(x))), atol=1e-5)
    u = np.random.RandomState(9).rand(4, 5).astype(np.float32)
    np.testing.assert_allclose(tcolor.inv_sigmoid(torch.tensor(u)).numpy(),
                               np.asarray(jcolor.inv_sigmoid(jnp.asarray(u))),
                               atol=1e-5)
