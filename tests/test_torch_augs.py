"""The port's `fast` augmentation (aphantasia_torch/ops/{augs,perspective,
sep_warp}.py) against the JAX package, with the JAX-made draws fed to both.

Tolerances: the perspective fit and the affine maps 1e-4 (float32 closed
forms); the float32 warp 1e-4 on values in [0, 1] and its gradient 1e-4
relative; the erasing is exact.  The `fast` pipeline runs its warp in bf16
in both packages (augs.py:164), and the two round at the same products
but not always the same way, so the pipeline is held to 3e-2 on
CLIP-normalized values of magnitude up to ~3.8 (a few bf16 steps of
2^-8 relative; twice the largest difference seen), and its mean error
against the same pipeline in float32 may exceed the JAX package's own by
at most a quarter.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops import augs as jaugs
from aphantasia_tpu.ops import perspective as jpersp
from aphantasia_tpu.ops import sep_warp as jwarp
from aphantasia_torch.ops import augs as taugs
from aphantasia_torch.ops import perspective as tpersp
from aphantasia_torch.ops import sep_warp as twarp

from _torch_parity import jax_fast_draws, t


def _affines(s, h, w, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    start, end = jpersp.perspective_endpoints(k1, s, h, w, 0.33, 1.0)
    aff_p = jpersp.affine_fit_centered(jpersp.perspective_coeffs(start, end),
                                       h, w)
    return np.asarray(jaugs._compose(aff_p, jaugs.random_rotate_affine(k2, s)))


def test_perspective_fit_matches_jax():
    s, h, w = 8, 32, 32
    start, end = jpersp.perspective_endpoints(jax.random.PRNGKey(1), s, h, w,
                                              0.33, 0.5)
    cj = np.asarray(jpersp.perspective_coeffs(start, end))
    ct = tpersp.perspective_coeffs(t(start), t(end))
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4)
    fj = np.asarray(jpersp.affine_fit_centered(jnp.asarray(cj), h, w))
    ft = tpersp.affine_fit_centered(ct, h, w).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-4, atol=1e-4)


def test_perspective_draw_is_torchvision_shaped():
    g = torch.Generator().manual_seed(0)
    start, end = tpersp.perspective_endpoints(g, 2000, 224, 224, 0.33, 0.2)
    moved = (end != start[None]).any(-1).any(-1).float().mean().item()
    assert 0.17 < moved < 0.23
    assert end.min() >= 0 and end.max() <= 223


@pytest.mark.parametrize("fill", [0.0, 0.5])
def test_affine_warp_f32_matches_jax(fill):
    s, c, h, w = 4, 3, 24, 24
    aff = _affines(s, h, w)
    x = np.random.RandomState(2).rand(s, c, h, w).astype(np.float32)
    co = np.random.RandomState(3).randn(s, c, h, w).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jwarp.affine_warp(
        a, jnp.asarray(aff), pad=8, fill=fill), jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    out_t = twarp.affine_warp(xt, torch.tensor(aff), pad=8, fill=fill)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-4)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-4 * np.abs(g_j).max())


def test_scale_matrix_and_ldu_match_jax():
    sc = np.asarray([0.8, 1.0, 1.3], np.float32)
    off = np.asarray([-2.5, 0.0, 1.25], np.float32)
    mj = jwarp.scale_matrix_1d(jnp.asarray(sc), jnp.asarray(off), 10, n_in=14,
                               dst0=2)
    mt = twarp.scale_matrix_1d(torch.tensor(sc), torch.tensor(off), 10,
                               n_in=14, dst0=2)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    a2 = _affines(5, 16, 16)[:, :, :2]
    for a, b in zip(jwarp.ldu_decompose(jnp.asarray(a2)),
                    twarp.ldu_decompose(torch.tensor(a2))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)


def test_random_erasing_matches_jax():
    s, c, h, w = 16, 3, 20, 20
    key = jax.random.PRNGKey(4)
    cuts = np.random.RandomState(5).rand(s, c, h, w).astype(np.float32)
    out_j = np.asarray(jaugs.random_erasing(jax.random.split(key, 3)[2],
                                            jnp.asarray(cuts)))
    draws = jax_fast_draws(key, s, h, w).erasing
    out_t = taugs.random_erasing(draws, torch.tensor(cuts)).numpy()
    np.testing.assert_array_equal(out_t, out_j)


def test_fast_pipeline_matches_jax():
    s, c, m = 6, 3, 32
    key = jax.random.PRNGKey(6)
    cuts = np.random.RandomState(7).rand(s, c, m, m).astype(np.float32)
    out_j = np.asarray(jaugs.transforms_fast_affine(key, jnp.asarray(cuts)))
    draws = jax_fast_draws(key, s, m, m)
    out_t = taugs.transforms_fast_affine(draws, torch.tensor(cuts)).numpy()
    ref32 = taugs.transforms_fast_affine(draws, torch.tensor(cuts),
                                         compute_dtype=torch.float32).numpy()
    assert np.abs(out_t - out_j).max() <= 3e-2
    # the port's bf16 warp is as accurate as the JAX package's
    assert (np.abs(out_t - ref32).mean()
            <= 1.25 * np.abs(out_j - ref32).mean())


def test_get_transform():
    g = torch.Generator().manual_seed(0)
    tf = taugs.get_transform("fast")
    d = tf.draw(g, 5, 32, 32)
    assert d.endpoints.shape == (5, 4, 2) and d.rot_idx.shape == (5,)
    out = tf.apply(d, torch.rand(5, 3, 32, 32))
    assert out.shape == (5, 3, 32, 32) and torch.isfinite(out).all()
    none = taugs.get_transform("none")
    x = torch.rand(2, 3, 8, 8)
    torch.testing.assert_close(none.apply(none.draw(g, 2, 8, 8), x),
                               taugs.clip_normalize(x))
    for name in ("custom", "elastic", "lucent", "openai"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            taugs.get_transform(name)
