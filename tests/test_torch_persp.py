"""The port's exact perspective warp (aphantasia_torch/ops/{persp,
perspective}.py) against the JAX package's `homography_warp`, the plain
reference of its Pallas kernel, with the same coefficients on both sides.

On the CPU `perspective_warp` runs its plain version (autograd's exact
transpose for the backward); the JAX function's backward is its windowed
custom VJP, so the gradient test also holds that window to the exact
transpose.  The window of the CUDA backward (csrc/persp.cu, R = 3) is
checked here too, at the family's extreme corner draws and at +-30 deg.

Tolerances: float32 values in [0, 1] and their gradients 1e-5 (the same
four taps summed in the same order; the gradient sums in another order);
coefficient algebra 1e-5 relative (float32 closed forms); flag-0 samples
and the compact route exact.
"""
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops import perspective as jp
from aphantasia_torch.ops import persp as P
from aphantasia_torch.ops import perspective as tp


def _family(seed, s, h, w, p=0.7):
    sp, ep = jp.perspective_endpoints(jax.random.PRNGKey(seed), s, h, w,
                                      distortion=0.33, p=p)
    coef = jp.perspective_coeffs(sp, ep)
    flags = (jnp.abs(ep - sp[None]).max((1, 2)) > 0).astype(jnp.int32)
    return np.asarray(coef), np.asarray(flags)


def _jax_warp(img, coef, flags):
    """The JAX kernel's semantics on its plain reference: flagged samples
    warped, the others copied."""
    keep = jnp.asarray(flags == 0)[:, None, None, None]
    return jnp.where(keep, img, jp.homography_warp(img, jnp.asarray(coef)))


def _check_against_jax(coef, flags, h, w, seed=0):
    s = coef.shape[0]
    rng = np.random.RandomState(seed)
    img = rng.rand(s, 3, h, w).astype(np.float32)
    co = rng.randn(s, 3, h, w).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x: _jax_warp(x, coef, flags), jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(img, requires_grad=True)
    out_t = P.perspective_warp(xt, torch.tensor(coef), torch.tensor(flags))
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)
    keep = flags == 0
    assert np.array_equal(out_t.detach().numpy()[keep], img[keep])
    assert np.array_equal(g_t.numpy()[keep], co[keep])


@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_persp_family_matches_jax(hw):
    """Mixed flags; 40 is not a multiple of 16 (the JAX kernel's tile)."""
    h, w = hw
    coef, flags = _family(0, 8, h, w)
    assert 0 < flags.sum() < len(flags)
    _check_against_jax(coef, flags, h, w)


def test_rotate_family_matches_jax():
    h = w = 36
    angles = np.asarray([-30.0, -17.0, -3.0, 0.0, 8.0, 15.0, 30.0],
                        np.float32)
    cj = np.asarray(jp.rotation_coeffs_for(jnp.asarray(angles), h, w))
    ct = tp.rotation_coeffs_for(torch.tensor(angles), h, w).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)
    _check_against_jax(cj, (angles != 0).astype(np.int32), h, w)
    out = P.perspective_warp(torch.rand(7, 3, h, w), torch.tensor(ct),
                             torch.tensor(angles != 0), family="rotate")
    assert out.shape == (7, 3, h, w)


def test_flag_zero_copies_and_default_flags():
    """A flag-0 sample is copied bit for bit, even where its coeffs are
    not the identity; without flags, non-identity coeffs are flagged."""
    coef, _ = _family(1, 4, 24, 24, p=1.0)
    img = torch.rand(4, 3, 24, 24)
    flags = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    out = P.perspective_warp(img, torch.tensor(coef), flags)
    assert torch.equal(out[0], img[0]) and torch.equal(out[2], img[2])
    assert not torch.equal(out[1], img[1])
    ident = torch.tensor([[1, 0, 0, 0, 1, 0, 0, 0]], dtype=torch.float32)
    both = torch.cat([ident, torch.tensor(coef[:1])])
    _, f = P._prep(img[:2], both, None)
    assert f.tolist() == [0, 1]


def test_plain_bf16_rounds_the_float32_warp_once():
    coef, flags = _family(2, 4, 24, 24, p=1.0)
    img = torch.rand(4, 3, 24, 24).to(torch.bfloat16)
    out = P.perspective_warp(img, torch.tensor(coef), torch.tensor(flags))
    ref = P.perspective_warp(img.float(), torch.tensor(coef),
                             torch.tensor(flags)).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_compose_and_inverse_coeffs_match_jax():
    c1, _ = _family(3, 5, 32, 32, p=1.0)
    c2 = np.asarray(jp.rotation_coeffs_for(
        jnp.asarray([-20.0, -5.0, 0.0, 12.0, 30.0]), 32, 32))
    want = np.asarray(jp.compose_coeffs(jnp.asarray(c1), jnp.asarray(c2)))
    got = tp.compose_coeffs(torch.tensor(c1), torch.tensor(c2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    inv_j = np.asarray(jp._inverse_coeffs(jnp.asarray(c1)))
    inv_t = tp._inverse_coeffs(torch.tensor(c1)).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-5, atol=1e-5)
    # the inverse maps a warped position back: M^-1 M p = p
    m = np.concatenate([c1, np.ones((5, 1), np.float32)], 1).reshape(5, 3, 3)
    prod = np.einsum("sij,sjk->sik", inv_t, m)
    prod /= prod[:, 2:3, 2:3]
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(3), prod.shape),
                               atol=1e-4)


def test_compact_matches_full():
    """Within the budget (drawn samples permuted first) and over it (the
    full batch), value and gradient equal the full warp's."""
    h = w = 24
    s = 12
    coef, flags = _family(4, s, h, w, p=0.5)
    n = int(flags.sum())
    assert 0 < n < s - 1
    img = np.random.RandomState(5).rand(s, 3, h, w).astype(np.float32)
    co = torch.tensor(np.random.RandomState(6).randn(s, 3, h, w)
                      .astype(np.float32))
    ct, ft = torch.tensor(coef), torch.tensor(flags)
    x = torch.tensor(img, requires_grad=True)
    ref = P.perspective_warp(x, ct, ft)
    (g_ref,) = torch.autograd.grad(ref, x, co)
    for budget in (n + 1, n - 1):
        x = torch.tensor(img, requires_grad=True)
        out = P.perspective_warp_compact(x, ct, ft, budget=budget)
        (g,) = torch.autograd.grad(out, x, co)
        assert torch.equal(out, ref) and torch.equal(g, g_ref)
    assert P.default_budget(200) == 72 and P.default_budget(8) == 8


def _window_reach(coef, h, w):
    """The largest |p - round(dst(q))|_inf over every output pixel p and
    each in-frame tap q that p reads with nonzero weight, dst being the
    inverse map the CUDA backward centres its window on."""
    coef = torch.tensor(coef)
    xx, yy = tp._grids(h, w, "cpu")
    sx, sy = tp._src_positions(coef, xx, yy)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = sx - x0, sy - y0
    inv = tp._inverse_coeffs(coef)
    reach = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            qx, qy = x0 + dx, y0 + dy
            wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
            used = (wgt > 0) & (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            xq, yq = qx + 0.5, qy + 0.5
            m = [inv[:, i, j][:, None, None] for i in range(3)
                 for j in range(3)]
            den = m[6] * xq + m[7] * yq + m[8]
            px = (m[0] * xq + m[1] * yq + m[2]) / den - 0.5
            py = (m[3] * xq + m[4] * yq + m[5]) / den - 0.5
            d = torch.maximum((torch.round(px) - xx + 0.5).abs(),
                              (torch.round(py) - yy + 0.5).abs())
            reach = max(reach, float(d[used].max()))
    return reach


def test_backward_window_covers_the_families():
    """The CUDA backward walks output pixels within 3 of round(dst(q)):
    enough at every extreme corner draw of the distortion-0.33 family (the
    JAX package's window-bound draws) and at +-30 deg rotations."""
    h = w = 224
    dw, dh = int(0.33 * (w // 2)), int(0.33 * (h // 2))
    los_his = [(0, dw), (0, dh), (w - dw - 1, w - 1), (0, dh),
               (w - dw - 1, w - 1), (h - dh - 1, h - 1),
               (0, dw), (h - dh - 1, h - 1)]
    pts = np.array(list(itertools.product(*los_his)), np.float32)
    sp = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                      dtype=torch.float32)
    corners = tp.perspective_coeffs(sp, torch.tensor(pts).reshape(-1, 4, 2))
    rot = tp.rotation_coeffs_for(torch.tensor([-30.0, -21.0, 13.0, 30.0]),
                                 h, w)
    for coef in torch.split(corners, 32) + (rot,):
        assert _window_reach(coef.numpy(), h, w) <= 3


def test_wrappers_raise_for_a_device_without_a_kernel():
    img = torch.zeros((2, 3, 8, 8), device="meta")
    coef = torch.zeros((2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        P.perspective_warp(img, coef, torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="family"):
        P.perspective_warp(torch.zeros(1, 3, 8, 8), torch.zeros(1, 8),
                           family="shear")


def test_draw_flags_follow_the_endpoints():
    """The `fast` draw's flags: a sample is warped exactly when one of its
    corners moved (torchvision's Bernoulli)."""
    from aphantasia_torch.ops.augs import draw_fast
    d = draw_fast(torch.Generator().manual_seed(0), 400, 64, 64)
    sp = torch.tensor([[0, 0], [63, 0], [63, 63], [0, 63]],
                      dtype=torch.float32)
    moved = (d.endpoints - sp[None]).abs().amax((1, 2)) > 0
    assert 0.12 < moved.float().mean().item() < 0.28
    coef = tp.perspective_coeffs(sp, d.endpoints)
    _, flags = P._prep(None, coef, moved)
    assert torch.equal(flags.bool(), moved)
