"""The port's fractional shift (aphantasia_torch/ops/{sep_warp,shift}.py)
against the JAX package: the plain `fractional_shift` against
`_frac_shift_vjp` (its XLA path with the custom VJP), and the kernel's
plain version `frac_shift_last` against the Pallas kernel
`pallas_frac_shift_last` in interpret mode, values and VJP, on the CASES
of tests/test_pallas_shift.py.

Tolerance 2e-4 (as that test's): float32 DFT products of up to 2n terms
summed in another order than XLA's, on values of magnitude ~3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops import pallas_shift
from aphantasia_tpu.ops.sep_warp import _frac_shift_vjp
from aphantasia_torch.ops import sep_warp as tw
from aphantasia_torch.ops import shift as ts

CASES = [
    # (lead, n_in, n_total, in_offset, out_window)
    ((3, 2, 16), 16, 24, 4, (0, 24)),     # L-pass shape: unpadded in, full out
    ((3, 2, 16), 24, 24, 0, (4, 16)),     # U-pass shape: padded in, cropped out
    ((5, 8), 12, 12, 0, (0, 12)),         # plain full-length shift
]
TOL = 2e-4


def _inputs(lead, n_in, win):
    x = np.random.RandomState(0).randn(*lead, n_in).astype(np.float32)
    sh_shape = (lead[0],) + (1,) * (len(lead) - 2) + (lead[-1],)
    shift = (3.0 * np.random.RandomState(1).randn(*sh_shape)).astype(np.float32)
    co = np.random.RandomState(2).randn(*lead, win[1]).astype(np.float32)
    return x, shift, co


@pytest.mark.parametrize("lead,n_in,n,off,win", CASES)
def test_fractional_shift_matches_jax(lead, n_in, n, off, win):
    x, shift, co = _inputs(lead, n_in, win)
    want, vjp = jax.vjp(lambda a: _frac_shift_vjp(
        a, jnp.asarray(shift), -1, "float32", n, off, win), jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    got = tw.fractional_shift(xt, torch.tensor(shift), axis=-1, n_total=n,
                              in_offset=off, out_window=win)
    (g_got,) = torch.autograd.grad(got, xt, torch.tensor(co))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want),
                               rtol=TOL, atol=TOL)


def test_fractional_shift_other_axis_matches_jax():
    """The elastic pipeline's y pass: axis -2 of [S, C, H, W] with one
    shift per column."""
    x = np.random.RandomState(3).randn(2, 3, 10, 14).astype(np.float32)
    shift = (4.0 * np.random.RandomState(4).rand(2, 1, 14) - 2.0).astype(
        np.float32)
    co = np.random.RandomState(5).randn(2, 3, 10, 14).astype(np.float32)
    want, vjp = jax.vjp(lambda a: _frac_shift_vjp(
        a, jnp.asarray(shift), -2, "float32", 10, 0, (0, 10)), jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    got = tw.fractional_shift(xt, torch.tensor(shift), axis=-2)
    (g_got,) = torch.autograd.grad(got, xt, torch.tensor(co))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want),
                               rtol=TOL, atol=TOL)


def test_kernel_plain_version_matches_pallas_interpret():
    """`frac_shift_last` on the CPU (the kernel's plain version) against
    the Pallas kernel run in interpret mode, values and VJP, on the
    windowed L-pass case."""
    lead, n_in, n, off, win = CASES[0]
    x, shift, co = _inputs(lead, n_in, win)

    def pallas(a):
        return pallas_shift.pallas_frac_shift_last(
            a, jnp.asarray(shift), "float32", n, off, win)
    want, vjp = jax.vjp(pallas, jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(co))
    rows = int(np.prod(lead))
    sh = torch.tensor(np.broadcast_to(shift, lead).reshape(rows))
    xt = torch.tensor(x.reshape(rows, n_in), requires_grad=True)
    got = ts.frac_shift_last(xt, sh, n, off, win)
    (g_got,) = torch.autograd.grad(got, xt,
                                   torch.tensor(co.reshape(rows, win[1])))
    np.testing.assert_allclose(got.detach().numpy().reshape(want.shape),
                               np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g_got.numpy().reshape(x.shape),
                               np.asarray(g_want), rtol=TOL, atol=TOL)


def test_switch_on_the_cpu_keeps_the_plain_pass(monkeypatch):
    """APHANTASIA_PALLAS_SHIFT sends only CUDA tensors to the kernel; a
    CPU tensor gives the same plain result with it set."""
    x, shift, _ = _inputs((4, 6), 12, (0, 12))
    plain = tw.fractional_shift(torch.tensor(x), torch.tensor(shift), -1)
    monkeypatch.setenv("APHANTASIA_PALLAS_SHIFT", "1")
    assert tw.shift_kernel_enabled()
    switched = tw.fractional_shift(torch.tensor(x), torch.tensor(shift), -1)
    assert torch.equal(plain, switched)
    monkeypatch.setenv("APHANTASIA_PALLAS_SHIFT", "")
    assert not tw.shift_kernel_enabled()


def test_shift_moves_content_by_whole_pixels():
    """A shift by an integer k moves a band-limited row by k places
    (out[i] = in[i - k]), cyclically over the full length."""
    n = 16
    i = np.arange(n)
    x = np.cos(2 * np.pi * 3 * i / n).astype(np.float32)[None]
    out = tw.fractional_shift(torch.tensor(x), torch.tensor([2.0]), -1)
    np.testing.assert_allclose(out.numpy()[0], np.roll(x[0], 2), atol=1e-5)


def test_wrapper_raises_for_a_device_without_a_kernel():
    with pytest.raises(RuntimeError, match="no kernel"):
        ts.frac_shift_last(torch.zeros((4, 8), device="meta"),
                           torch.zeros(4, device="meta"), 8)


@pytest.mark.parametrize("n_in,n,off,win", [(16, 24, 4, (0, 24)),
                                            (24, 24, 0, (4, 17))])
def test_kernel_matrices_cut_the_windows(n_in, n, off, win):
    """The windowed, zero-padded matrices the kernel reads give the plain
    version's result through the same three steps."""
    x = torch.tensor(np.random.RandomState(9).randn(5, n_in)
                     .astype(np.float32))
    sh = torch.tensor([0.3, -1.7, 2.5, 0.0, 4.1])
    a, b = ts._kernel_mats(n, off, n_in, win[0], win[1], "cpu")
    assert a.shape[1] % 4 == 0 and b.shape[1] % 4 == 0
    nf = n // 2 + 1
    f = x @ a
    k = torch.arange(nf, dtype=torch.float32)
    phi = -2.0 * np.pi * k * sh[:, None] / n
    c, s = torch.cos(phi), torch.sin(phi)
    fr, fi = f[:, :nf], f[:, nf:2 * nf]
    g = torch.cat([fr * c - fi * s, fr * s + fi * c], -1)
    got = (g @ b)[:, :win[1]]
    want = ts.frac_shift_plain(x, sh, n, off, win)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
