"""The port's fractional shift (aphantasia_torch/ops/{sep_warp,shift}.py)
against the JAX package: the plain `fractional_shift` against
`_frac_shift_vjp` (its XLA path with the custom VJP), and the kernel's
plain version `frac_shift_last` against the Pallas kernel
`pallas_frac_shift_last` in interpret mode, values and VJP, on the CASES
of tests/test_pallas_shift.py.

Tolerance 2e-4 (as that test's): float32 DFT products of up to 2n terms
summed in another order than XLA's, on values of magnitude ~3.  The CUDA
kernel's arithmetic (3xTF32 products on the matrices `_kernel_mats`
builds) is emulated here in float32 with tf32 rounded by bit operations,
and held to 1e-4 of the largest output, as the card holds the kernel.
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


def _emulate(x, sh, n, off, win, three=True):
    """The kernel's arithmetic in float32 on the CPU: for each spectrum
    chunk, x's columns in the slice order, the 3xTF32 analysis product
    against `_kernel_mats`'s ana^T (tf32 products are exact in float32),
    the phase rotation of each interleaved (re, im) pair, the rotated
    spectrum split the same way and the synthesis product, added to the
    earlier chunks'.  three=False: one tf32 product each (hi . hi)."""
    rows, n_in = x.shape
    na = ts.NA

    def product(a, b_hi, b_lo):
        a_hi, a_lo = ts.tf32_split(a)
        if not three:
            return a_hi @ b_hi.t()
        return a_lo @ b_hi.t() + a_hi @ b_lo.t() + a_hi @ b_hi.t()

    out = None
    for k0, (ana, syn) in zip(ts.spectrum_chunks(n),
                              ts._kernel_mats(n, off, n_in, *win, "cpu")):
        kp, s_rows = ana.shape[1], syn.shape[0] // 2
        xp = torch.nn.functional.pad(x, (0, kp - n_in))[:, ts.slice_order(kp)]
        f = product(xp, ana[:na], ana[na:])
        k = torch.arange(k0, k0 + na // 2, dtype=torch.float32)
        phi = -2.0 * np.pi * k * sh[:, None] / n
        c, s = torch.cos(phi), torch.sin(phi)
        re, im = f[:, 0::2], f[:, 1::2]
        g = torch.stack([re * c - im * s, re * s + im * c], -1).reshape(rows,
                                                                         na)
        part = product(g[:, ts.slice_order(na)], syn[:s_rows], syn[s_rows:])
        out = part if out is None else out + part
    return out[:, :win[1]]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("n_in,n,off,win", [(16, 24, 4, (0, 24)),
                                            (24, 24, 0, (4, 17)),
                                            (20, 26, 3, (3, 17))])
def test_kernel_matrices_cut_the_windows(n_in, n, off, win):
    """The windowed matrices the kernel reads (interleaved, in the slice
    order, K-major, split, zero-padded) give the plain version's result
    through the kernel's steps, emulated; the padding is zero."""
    x = torch.tensor(np.random.RandomState(9).randn(5, n_in)
                     .astype(np.float32))
    sh = torch.tensor([0.3, -1.7, 2.5, 0.0, 4.1])
    ((a, b),) = ts._kernel_mats(n, off, n_in, win[0], win[1], "cpu")
    na = ts.NA
    assert a.shape == (2 * na, -(-n_in // 8) * 8)
    assert b.shape == (2 * ts.PASS, na)
    nc = 2 * (n // 2 + 1)
    pad_k = ts.slice_order(a.shape[1]) >= n_in        # x's zero columns
    assert not a[:, pad_k].any() and not a[nc:na].any()
    assert not b[:, ts.slice_order(na) >= nc].any()
    assert not b[win[1]:ts.PASS].any()
    for half in (a, b):
        assert torch.equal(ts.tf32_round(half), half)
    want = ts.frac_shift_plain(x, sh, n, off, win)
    np.testing.assert_allclose(_emulate(x, sh, n, off, win).numpy(),
                               want.numpy(), atol=1e-5)


@pytest.mark.parametrize("lead,n_in,n,off,win", CASES)
def test_kernel_layout_emulation_matches_plain_on_jax_cases(lead, n_in, n,
                                                             off, win):
    """The kernel's 3xTF32 arithmetic, emulated on the wrapper's matrices,
    against the plain version (1e-4 of the largest output) and the JAX
    package's shift (TOL), forward and backward (the same kernel at
    -shift with the windows exchanged)."""
    x, shift, co = _inputs(lead, n_in, win)
    rows = int(np.prod(lead))
    sh = torch.tensor(np.broadcast_to(shift, lead).reshape(rows))
    xt = torch.tensor(x.reshape(rows, n_in))
    got = _emulate(xt, sh, n, off, win)
    assert _rel(got, ts.frac_shift_plain(xt, sh, n, off, win)) <= 1e-4
    want, vjp = jax.vjp(lambda a: _frac_shift_vjp(
        a, jnp.asarray(shift), -1, "float32", n, off, win), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy().reshape(want.shape),
                               np.asarray(want), rtol=TOL, atol=TOL)
    (g_want,) = vjp(jnp.asarray(co))
    g_got = _emulate(torch.tensor(co.reshape(rows, win[1])), -sh, n, win[0],
                     (off, n_in))
    np.testing.assert_allclose(g_got.numpy().reshape(x.shape),
                               np.asarray(g_want), rtol=TOL, atol=TOL)


def test_3xtf32_holds_1e_4_at_the_main_shape(capsys):
    """At [4096, 224] with shifts of +-6 px, the emulated 3xTF32 kernel is
    within 1e-4 of the largest plain output.  One tf32 product per
    multiply (hi . hi) is measured beside it and printed, with no
    assertion: it is the error the split removes."""
    rs = np.random.RandomState(11)
    x = torch.tensor(rs.randn(4096, 224).astype(np.float32))
    sh = torch.tensor(((rs.rand(4096) * 2 - 1) * 6).astype(np.float32))
    want = ts.frac_shift_plain(x, sh, 224, 0, (0, 224))
    three = _rel(_emulate(x, sh, 224, 0, (0, 224)), want)
    one = _rel(_emulate(x, sh, 224, 0, (0, 224), three=False), want)
    with capsys.disabled():
        print(f"\n[frac_shift emulated, 4096x224] max|err| / max|ref|: "
              f"3xTF32 {three:.3g}, 1xTF32 {one:.3g}")
    assert three <= 1e-4


def test_tf32_rounding_is_to_nearest_ties_away():
    """`tf32_round` keeps 10 mantissa bits, rounding as cvt.rna does: a
    tie goes away from zero, either sign; `tf32_split`'s parts add up to
    the value within 2^-21 of it."""
    ulp = 2.0 ** -10
    t = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4, 3.0])
    assert ts.tf32_round(t).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0,
                                         1.0 + ulp, 3.0]
    v = torch.tensor(np.random.RandomState(2).randn(1000).astype(np.float32))
    hi, lo = ts.tf32_split(v)
    assert torch.equal(ts.tf32_round(lo), lo)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("n,chunks", [(224, 1), (230, 1), (232, 2),
                                      (250, 2), (336, 2), (480, 3)])
def test_a_long_spectrum_runs_in_chunks_of_one_product(n, chunks):
    """A signal whose 2nf packed spectrum columns pass one product's 232
    runs in chunks of 116 frequencies, each chunk's matrices holding its
    own columns (zero past the spectrum); the chunks' outputs, added in
    order, are the whole spectrum's, held as the main shape is (1e-4 of
    the largest output) against the plain version."""
    nf = n // 2 + 1
    assert ts.spectrum_chunks(n) == tuple(range(0, 116 * chunks, 116))
    mats = ts._kernel_mats(n, 0, n, 0, n, "cpu")
    assert len(mats) == chunks
    last = 2 * (nf - 116 * (chunks - 1))        # the last chunk's columns
    a, b = mats[-1]
    assert not a[last:ts.NA].any() and not a[ts.NA + last:].any()
    assert not b[:, ts.slice_order(ts.NA) >= last].any()
    rs = np.random.RandomState(n)
    x = torch.tensor(rs.randn(64, n).astype(np.float32))
    sh = torch.tensor(((rs.rand(64) * 2 - 1) * 6).astype(np.float32))
    want = ts.frac_shift_plain(x, sh, n, 0, (0, n))
    assert _rel(_emulate(x, sh, n, 0, (0, n)), want) <= 1e-4
