"""The port's cutout sampler and cutout kernel's plain version
(aphantasia_torch/ops/sampler.py, ops/cutout.py) against the JAX package's
CutoutSampler (einsum path) and its Pallas cutout (interpret mode), on the
same JAX-drawn boxes, forward and gradient.

Tolerances: 1e-5 on the forward and 1e-4 on the gradient (float32 sums
in another order).  The port's `use_pallas` forward computes the Pallas
kernel's function, roundings included (the frame, the dense weights and
the row pass to bf16, pallas_cutout.py:107, :60-64), and is held to it at
1e-5; the float32 gather, whose transpose is the backward of both, is held
to the dense einsum.  The CUDA kernels are held against the plain version
on the card (tests/test_torch_gpu.py and chip_smoke.py's kernel phase).
The backward's range pre-pass (its plain twin `tile_ranges`) must enclose
every weighted tap exactly: a tap it misses is a term the kernel drops.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_tpu.ops.pallas_cutout import pallas_cut
from aphantasia_torch.ops import cutout as C
from aphantasia_torch.ops.sampler import Boxes, CutoutSampler


def _setup(h, w, s, m, align="uniform", macro=0.4, seed=0):
    js = JSampler((h, w), s, m, align, macro)
    boxes = js.sample_boxes(jax.random.PRNGKey(seed))
    ts = CutoutSampler((h, w), s, m, align, macro)
    tb = Boxes(*(torch.as_tensor(np.array(b)) for b in boxes))
    img = np.random.RandomState(seed).rand(3, h, w).astype(np.float32)
    co = np.random.RandomState(seed + 1).randn(s, 3, m, m).astype(np.float32)
    return js, boxes, ts, tb, img, co


def _jax_vjp(fn, img, co):
    out, vjp = jax.vjp(fn, jnp.asarray(img))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(co))[0])


def _torch_vjp(fn, img, co):
    x = torch.tensor(img, requires_grad=True)
    out = fn(x)
    (g,) = torch.autograd.grad(out, x, torch.tensor(co))
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("align", ["uniform", "central", "overscan", "overmax"])
def test_taps_match_jax(align):
    js, boxes, ts, tb, _, _ = _setup(40, 56, 6, 24, align)
    for a, b in zip(js.tap_indices(boxes), ts.tap_indices(tb)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("h,w,chunk", [(40, 56, 0), (56, 40, 0), (40, 56, 4)])
def test_einsum_cut_matches_jax(h, w, chunk):
    """The default contraction (W first when H < W, chunked or not)."""
    js, boxes, ts, tb, img, co = _setup(h, w, 6, 24)
    js = JSampler((h, w), 6, 24, "uniform", 0.4, chunk=chunk)
    ts = CutoutSampler((h, w), 6, 24, "uniform", 0.4, chunk=chunk)
    out_j, g_j = _jax_vjp(lambda x: js.cut(x, boxes), img, co)
    out_t, g_t = _torch_vjp(lambda x: ts.cut(x, tb), img, co)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4)


@pytest.mark.parametrize("h,w,align", [(40, 56, "uniform"),
                                       (40, 56, "overscan"),
                                       (20, 28, "uniform")])
def test_gather_plain_matches_jax_einsum(h, w, align):
    """The `use_pallas` sampler equals the JAX `use_pallas` sampler (the
    Pallas cutout in interpret mode, bf16 roundings included), and the
    float32 gather whose transpose is its backward equals the dense
    contraction, also where crops outgrow the frame (20x28 < M)."""
    js, boxes, ts, tb, img, co = _setup(h, w, 6, 24, align)
    jp = JSampler((h, w), 6, 24, align, 0.4, use_pallas=True)
    tp = CutoutSampler((h, w), 6, 24, align, 0.4, use_pallas=True)
    out_j, g_j = _jax_vjp(lambda x: jp.cut(x, boxes), img, co)
    out_t, g_t = _torch_vjp(lambda x: tp.cut(x, tb), img, co)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4)
    out_j, g_j = _jax_vjp(lambda x: js.cut(x, boxes), img, co)
    out_t, g_t = _torch_vjp(
        lambda x: C.gather_f32(x, *ts.tap_indices(tb)), img, co)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4)


@pytest.mark.parametrize("h,w,align", [(40, 56, "uniform"),
                                       (40, 56, "overscan"),
                                       (20, 28, "uniform")])
def test_gather_plain_matches_pallas_interpret(h, w, align):
    """`cutout` on CPU tensors (the plain version) against `pallas_cut` in
    interpret mode: the bf16 roundings of the forward, summed over each
    row's and column's distinct taps in ascending frame index, and the
    float32 transpose as the gradient; uniform crops, overscan's folded
    taps and crops larger than a 20x28 frame (M = 24)."""
    s, m = 5, 24
    _, boxes, ts, tb, img, co = _setup(h, w, s, m, align)
    js = JSampler((h, w), s, m, align, 0.4, use_pallas=True)
    out_j, g_j = _jax_vjp(lambda x: pallas_cut(js, x, boxes), img, co)
    out_t, g_t = _torch_vjp(lambda x: C.cutout(x, *ts.tap_indices(tb)),
                            img, co)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4)


def test_distinct_taps_sum_each_pixel_once():
    """Taps on one index (the clamped crop edge, overscan folding) give one
    weight, their float32 sum in tap order rounded once to bf16, at the
    index's first place in ascending order; the others weigh 0."""
    idx = torch.tensor([[[5, 3, 5, 4], [0, 0, 1, 2]]], dtype=torch.int32)
    wts = torch.tensor([[[0.1, 0.2, 0.3, 0.4], [0.5, 0.25, 0.125, 1 / 3]]])
    si, sw = C.distinct_taps(idx, wts)
    assert si.tolist() == [[[3, 4, 5, 5], [0, 0, 1, 2]]]
    bf = lambda v: torch.as_tensor(v, dtype=torch.float32).bfloat16().item()
    assert sw.tolist() == [[[bf(0.2), bf(0.4), bf(torch.tensor(0.1) + 0.3),
                             0.0],
                            [bf(0.75), 0.0, bf(0.125), bf(1 / 3)]]]


@pytest.mark.parametrize("h,w", [(48, 80), (80, 48)])
def test_contract_bf16_sums_in_float32_as_jax(h, w):
    """The dense contraction at bf16 against JAX's `_contract(...,
    "bfloat16")`, both contraction orders: the first product of each
    direction rounds to bf16 and the second is summed and returned in
    float32 (preferred_element_type=float32).  Held to 1e-5 relative to the
    largest entry, float32 summation-order noise; a second product rounded
    to bf16 (the image gradient then holds only bf16 values) misses by
    about 3e-3."""
    from aphantasia_tpu.ops.sampler import _contract as jcontract
    from aphantasia_torch.ops.sampler import _contract
    s, m, c = 6, 32, 3
    rs = np.random.RandomState(0)
    img = rs.rand(c, h, w).astype(np.float32)
    wy = jnp.asarray(rs.rand(s, m, h) - 0.3, jnp.bfloat16)
    wx = jnp.asarray(rs.rand(s, m, w) - 0.3, jnp.bfloat16)
    co = rs.randn(s, c, m, m).astype(np.float32)
    out_j, g_j = _jax_vjp(lambda x: jcontract(x, wy, wx, "bfloat16"), img, co)
    twy, twx = (torch.tensor(np.asarray(a, np.float32)).bfloat16()
                for a in (wy, wx))
    out_t, g_t = _torch_vjp(lambda x: _contract(x, twy, twx, torch.bfloat16),
                            img, co)
    assert out_t.dtype == np.float32 and g_t.dtype == np.float32
    np.testing.assert_allclose(out_t, out_j, atol=1e-5 * np.abs(out_j).max())
    np.testing.assert_allclose(g_t, g_j, atol=1e-5 * np.abs(g_j).max())


def test_in_frame_drops_outside_taps():
    idx = torch.tensor([[[-1, 0, 3, 4]]], dtype=torch.int32)
    wts = torch.ones((1, 1, 4))
    i, w = C.in_frame(idx, wts, 4)
    assert i.tolist() == [[[0, 0, 3, 3]]]
    assert w.tolist() == [[[0.0, 1.0, 1.0, 0.0]]]


def test_checked_refuses_bad_taps():
    img = torch.zeros(3, 8, 8)
    taps = (torch.zeros(2, 4, 4, dtype=torch.int64), torch.zeros(2, 4, 4),
            torch.zeros(2, 4, 4, dtype=torch.int32), torch.zeros(2, 4, 4))
    with pytest.raises(TypeError):
        C._checked(img, *taps)


@pytest.mark.parametrize("h,w,s,m,align", [(40, 56, 6, 24, "uniform"),
                                           (72, 100, 8, 24, "overscan"),
                                           (72, 100, 8, 24, "overmax"),
                                           (40, 56, 6, 64, "uniform")])
def test_tile_ranges_enclose_every_weighted_tap(h, w, s, m, align):
    """On JAX-drawn boxes (uniform, the overscan tile maps whose taps are
    not monotone in m, and crops larger than the 40x56 frame whose
    out-of-frame taps are clamped with no weight): every tap with a weight
    lies inside its sample's range for its band and for its pixel; a band
    or pixel no weighted tap reaches has an empty range."""
    _, _, ts, tb, _, _ = _setup(h, w, s, m, align)
    yidx, yw, xidx, xw = ts.tap_indices(tb)
    yidx, yw = C.in_frame(yidx, yw, h)
    xidx, xw = C.in_frame(xidx, xw, w)
    table = C.tile_ranges(yidx, yw, xidx, xw, h, w).numpy()
    nby = -(-h // C.TILE)
    rows_at, cols_at, width = C.table_layout(h, w)
    assert table.shape == (s, width, 2)
    assert rows_at % 2 == 0 and cols_at % 2 == 0 and width % 2 == 0
    # (taps, weights, offset of the band ranges, of the pixel ranges)
    for idx, wts, band0, pix0, n in ((yidx, yw, 0, rows_at, h),
                                     (xidx, xw, nby, cols_at, w)):
        idx, wts = idx.numpy(), wts.numpy()
        reached = np.zeros(table.shape[:2], bool)
        for smp, q, t in zip(*np.nonzero(wts)):
            for col in (band0 + idx[smp, q, t] // C.TILE,
                        pix0 + idx[smp, q, t]):
                lo, hi = table[smp, col]
                assert lo <= q <= hi, (smp, q, t, col, lo, hi)
                reached[smp, col] = True
        for part in (slice(band0, band0 + -(-n // C.TILE)),
                     slice(pix0, pix0 + n)):
            nonempty = table[:, part, 0] <= table[:, part, 1]
            assert (nonempty == reached[:, part]).all()
