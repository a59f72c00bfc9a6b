"""The port's cutout sampler and cutout kernel's plain version
(aphantasia_torch/ops/sampler.py, ops/cutout.py) against the JAX package's
CutoutSampler (einsum path) and its Pallas cutout (interpret mode), on the
same JAX-drawn boxes, forward and gradient.

Tolerances: float32 paths 1e-5 on the forward and 1e-4 on the gradient
(sum orders differ).  The Pallas forward rounds the frame, the dense
weights and the row pass to bf16 (pallas_cutout.py:107, :60-64), three
roundings of 2^-8 each, so the forward against it is held to 2e-2 on
values in [0, 1.2]; its backward stays float32 and keeps 1e-4.  The CUDA
kernel is held against the plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py's kernel phase).
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
    """The kernel's plain version (16-tap gather, scatter backward) equals
    the dense contraction, also where crops outgrow the frame (20x28 < M)."""
    js, boxes, ts, tb, img, co = _setup(h, w, 6, 24, align)
    ts = CutoutSampler((h, w), 6, 24, align, 0.4, use_pallas=True)
    out_j, g_j = _jax_vjp(lambda x: js.cut(x, boxes), img, co)
    out_t, g_t = _torch_vjp(lambda x: ts.cut(x, tb), img, co)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4)


def test_gather_plain_matches_pallas_interpret():
    h, w, s, m = 40, 56, 5, 24
    js, boxes, ts, tb, img, co = _setup(h, w, s, m)
    js = JSampler((h, w), s, m, "uniform", 0.4, use_pallas=True)
    out_j, g_j = _jax_vjp(lambda x: pallas_cut(js, x, boxes), img, co)
    out_t, g_t = _torch_vjp(lambda x: C.cutout(x, *ts.tap_indices(tb)),
                            img, co)
    np.testing.assert_allclose(out_t, out_j, atol=2e-2)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4)


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
