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


# the CUDA backward's tile of input pixels, its row and entry capacity and
# its slacks (csrc/persp.cu: kQx, kQy, kMaxRows, kEntries, kSlack, kEps,
# kEpsRel)
_TILE_X, _TILE_Y, _MAX_ROWS, _ENTRIES = 32, 32, 128, 2272
_SLACK, _EPS, _EPS_REL = .25, .05, 1e-3


def _p_star(inv, xs, ys):
    """The output position whose sample lands on input position (xs, ys)
    (pixel indices): the inverse map, [S,1,1] coefficients."""
    m = [inv[:, i, j].reshape(-1, *[1] * (xs.ndim - 1)) for i in range(3)
         for j in range(3)]
    xq, yq = xs + 0.5, ys + 0.5
    den = m[6] * xq + m[7] * yq + m[8]
    return ((m[0] * xq + m[1] * yq + m[2]) / den - 0.5,
            (m[3] * xq + m[4] * yq + m[5]) / den - 0.5, den)


def _row_interval(coef, py, x0s, x1s, y0s, y1s, w):
    """The output pixels of row py whose sample lands in [x0s, x1s] x
    [y0s, y1s], as (lo, hi) cut to the frame, solved as the kernel does
    (`row_interval`); every argument broadcasts."""
    a, b, c, d, e, f, g, h = coef.unbind(-1)
    yy = py + 0.5
    hd, bx, by = h * yy + 1, b * yy + c, e * yy + f
    lo = torch.full_like(yy * a, -np.inf)
    hi = torch.full_like(lo, np.inf)
    for kx, r, ge in ((a - (x0s + .5) * g, (x0s + .5) * hd - bx, True),
                      (a - (x1s + .5) * g, (x1s + .5) * hd - bx, False),
                      (d - (y0s + .5) * g, (y0s + .5) * hd - by, True),
                      (d - (y1s + .5) * g, (y1s + .5) * hd - by, False)):
        flat = kx.abs() < 1e-12
        bad = flat & ((r > 0) if ge else (r < 0))
        x = r / torch.where(flat, torch.ones_like(kx), kx)
        if ge:
            lo = torch.where(~flat & (kx > 0), torch.maximum(lo, x), lo)
            hi = torch.where(~flat & (kx < 0), torch.minimum(hi, x), hi)
        else:
            hi = torch.where(~flat & (kx > 0), torch.minimum(hi, x), hi)
            lo = torch.where(~flat & (kx < 0), torch.maximum(lo, x), lo)
        lo = torch.where(bad, torch.full_like(lo, np.inf), lo)
        hi = torch.where(bad, torch.full_like(hi, -np.inf), hi)
    return (torch.clamp(torch.ceil(lo - .5), 0, w),
            torch.clamp(torch.floor(hi - .5), -1, w - 1))


def _geometry_misses(coef, h, w):
    """Brute force over every output pixel p and each in-frame tap q it
    reads: the pairs where p lies outside the rows or the row interval of
    q's tile, or outside q's window (within the tile's reach of p*(q)), as
    the CUDA backward reckons them; and the most rows and entries a tile
    holds.  Returns (misses, rows, entries)."""
    coef = torch.tensor(coef)
    inv = tp._inverse_coeffs(coef)
    s = coef.shape[0]
    tx0 = torch.arange(0, w, _TILE_X, dtype=torch.float32)[None, None, :]
    ty0 = torch.arange(0, h, _TILE_Y, dtype=torch.float32)[None, :, None]
    x0s = tx0 - 1 - _SLACK
    x1s = torch.clamp(tx0 + _TILE_X, max=w) - 1 + 1 + _SLACK
    y0s = ty0 - 1 - _SLACK
    y1s = torch.clamp(ty0 + _TILE_Y, max=h) - 1 + 1 + _SLACK
    corners = [_p_star(inv, xs.expand(s, *ty0.shape[1:2], tx0.shape[2]),
                       ys.expand(s, ty0.shape[1], tx0.shape[2]))
               for xs in (x0s, x1s) for ys in (y0s, y1s)]
    pys = torch.stack([cn[1] for cn in corners])
    dens = torch.stack([cn[2] for cn in corners])
    assert bool(((dens > 0).all(0) | (dens < 0).all(0)).all())
    by0 = torch.clamp(torch.floor(pys.amin(0)), 0, h)
    by1 = torch.clamp(torch.ceil(pys.amax(0)), -1, h - 1)
    rows = int((by1 - by0 + 1).clamp(min=0).max())
    # how far p* moves for a step of up to a pixel on each axis: the
    # numerators of dp/dx, dp/dy are linear in one coordinate, D^2 is
    # least at a corner
    mm = [inv[:, i // 3, i % 3][:, None, None] for i in range(9)]
    min_d2 = (dens ** 2).amin(0)
    xa, xb, ya, yb = x0s + .5, x1s + .5, y0s + .5, y1s + .5

    def reach(r0, r1, r2):
        ax, bx = r0 * mm[7] - mm[6] * r1, r0 * mm[8] - mm[6] * r2
        ay, by = r1 * mm[6] - mm[7] * r0, r1 * mm[8] - mm[7] * r2
        return ((torch.maximum((ax * ya + bx).abs(), (ax * yb + bx).abs())
                 + torch.maximum((ay * xa + by).abs(), (ay * xb + by).abs()))
                / min_d2 * (1 + _EPS_REL) + _EPS)
    reach_x, reach_y = reach(*mm[0:3]), reach(*mm[3:6])
    # entries: the rows' interval lengths summed, per tile
    r = torch.arange(rows, dtype=torch.float32)
    py = by0[..., None] + r
    cf = coef[:, None, None, None, :]
    lo, hi = _row_interval(cf, py, x0s[..., None], x1s[..., None],
                           y0s[..., None], y1s[..., None], w)
    length = torch.where(py <= by1[..., None], (hi - lo + 1).clamp(min=0),
                         torch.zeros_like(lo))
    entries = int(length.sum(-1).max())
    # every (p, q) pair by brute force
    xx, yy = tp._grids(h, w, "cpu")
    sx, sy = tp._src_positions(coef, xx, yy)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    px, py = (xx - 0.5).expand(s, h, w), (yy - 0.5).expand(s, h, w)
    sidx = torch.arange(s)[:, None, None].expand(s, h, w)
    misses = 0
    for dy in (0, 1):
        for dx in (0, 1):
            qx, qy = x0 + dx, y0 + dy
            ok = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            qx, qy = qx.clamp(0, w - 1), qy.clamp(0, h - 1)
            tx = (qx // _TILE_X).long()
            ty = (qy // _TILE_Y).long()
            lo, hi = _row_interval(
                coef[sidx], py, x0s[0, 0, tx], x1s[0, 0, tx],
                y0s[0, ty, 0], y1s[0, ty, 0], w)
            inside = ((py >= by0[sidx, ty, tx]) & (py <= by1[sidx, ty, tx])
                      & (px >= lo) & (px <= hi))
            cx, cy, _ = _p_star(inv, qx, qy)
            rx, ry = reach_x[sidx, ty, tx], reach_y[sidx, ty, tx]
            inside &= ((px >= torch.ceil(cx - rx)) & (px <= torch.floor(cx + rx))
                       & (py >= torch.ceil(cy - ry))
                       & (py <= torch.floor(cy + ry)))
            misses += int((ok & ~inside).sum())
    return misses, rows, entries


def test_backward_window_covers_the_families():
    """The CUDA backward walks output pixels within 3 of round(dst(q)):
    enough at every extreme corner draw of the distortion-0.33 family (the
    JAX package's window-bound draws) and at +-30 deg rotations.  The rows
    and row intervals of its tiles, and each pixel's window (the tile's
    reach around its inverse position), hold every output pixel that
    reaches a pixel, at 224x224 and on a 200x216 frame, within the
    capacities there, so no block of either family leaves the
    shared-memory walk."""
    for h, w in ((224, 224), (200, 216)):
        dw, dh = int(0.33 * (w // 2)), int(0.33 * (h // 2))
        los_his = [(0, dw), (0, dh), (w - dw - 1, w - 1), (0, dh),
                   (w - dw - 1, w - 1), (h - dh - 1, h - 1),
                   (0, dw), (h - dh - 1, h - 1)]
        pts = np.array(list(itertools.product(*los_his)), np.float32)
        sp = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                          dtype=torch.float32)
        corners = tp.perspective_coeffs(sp,
                                        torch.tensor(pts).reshape(-1, 4, 2))
        rot = tp.rotation_coeffs_for(
            torch.tensor([-30.0, -21.0, 0.0, 13.0, 30.0]), h, w)
        drawn, _ = _family(7, 32, h, w, p=1.0)
        for coef in torch.split(corners, 32) + (rot, torch.tensor(drawn)):
            assert _window_reach(coef.numpy(), h, w) <= 3
            misses, rows, entries = _geometry_misses(coef.numpy(), h, w)
            assert misses == 0
            assert rows <= _MAX_ROWS and entries <= _ENTRIES, (rows, entries)


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
