"""The fractional shift pass as a hand-written CUDA kernel (csrc/shift.cu),
with its plain PyTorch version beside it (counterpart of
aphantasia_tpu.ops.pallas_shift).

`frac_shift_last(x, shift, n, in_offset, out_window)` shifts every row of
x [R, n_in] (the window at `in_offset` of a length-n signal) by its own
fractional `shift` [R] through the real DFT: analysis product, per-row
phase rotation, synthesis product, keeping the output columns
`out_window = (start, size)`.  It replaces the Pallas kernel `_run`
(pallas_shift.py:73).  The backward is the same kernel on the cotangent at
-shift with the windows exchanged (`_pfs_bwd`, pallas_shift.py:123); both
directions count under `frac_shift`.

The kernel runs both products on the tensor cores in 3xTF32 (each float32
operand split into tf32 hi and lo parts, three products summed in
float32), bound by those operations: 81.6 GFLOP on the 226 packed
spectrum columns at [134400, 224], 0.165 ms at 495 TFLOP/s (the kernel
pads the spectrum to 232 columns and issues 84 GFLOP), where one tf32
product would be too coarse for float32's 1e-4 and the CUDA cores'
float32 FMAs take 0.41 ms for the products alone.
The spectrum stays in registers between the two products (csrc/shift.cu
explains the layout); `_kernel_mats` builds the matrices as the kernel
reads them, once per geometry.  One product holds NA = 232 spectrum
columns (116 frequencies, n <= 230); a longer signal runs in chunks of
116 frequencies, one launch each, every launch after the first adding to
the output (`spectrum_chunks`).

CUDA tensors launch the kernel; CPU tensors run `frac_shift_plain`;
anything else raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from aphantasia_torch import kernels

_SIGNATURES = {
    "frac_shift": [kernels.PTR] * 5 + [kernels.INT] * 8 + [kernels.PTR],
    "tf32_probe": [kernels.PTR] * 3 + [kernels.INT] * 2 + [kernels.PTR],
}
PASS = 112    # output columns of one synthesis pass (csrc/shift.cu)
NA = 232      # spectrum columns of one product: 116 frequencies
# The K order within each 8-wide slice of both products: position p holds
# row _SLICE[p], so the accumulator's column pair (2q, 2q + 1) of the
# spectrum is the A fragment's (q, q + 4) of the synthesis.
_SLICE = (0, 2, 4, 6, 1, 3, 5, 7)


def _mats(n: int, device: str):
    """The packed float32 analysis [n, 2nf] and synthesis [2nf, n]."""
    from aphantasia_torch.ops.sep_warp import _packed_tensors
    return _packed_tensors(n, torch.float32, device)


def _round_up(k: int, m: int) -> int:
    return -(-k // m) * m


def spectrum_chunks(n: int) -> tuple:
    """The first frequency of each chunk of NA / 2 frequencies that
    covers the nf = n/2 + 1 of length n: one launch each."""
    return tuple(range(0, n // 2 + 1, NA // 2))


def tf32_round(t):
    """float32 t rounded to tf32 as `cvt.rna.tf32.f32` rounds (to nearest,
    ties away from zero, 10 mantissa bits; the low 13 bits zero)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """(hi, lo) = (tf32(t), tf32(t - hi)): the 3xTF32 parts of t."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def slice_order(k: int):
    """Row indices that put a K axis of length k (a multiple of 8) in the
    kernel's order within each 8-wide slice."""
    base = torch.arange(0, k, 8)[:, None]
    return (base + torch.tensor(_SLICE)[None, :]).reshape(-1)


def _interleave(m, nf: int, dim: int):
    """The packed [re | im] halves of a DFT matrix along `dim` as (re_0,
    im_0, re_1, im_1, ...)."""
    re, im = m.narrow(dim, 0, nf), m.narrow(dim, nf, nf)
    return torch.stack([re, im], dim=dim + 1).flatten(dim, dim + 1)


@functools.lru_cache(maxsize=32)
def _kernel_mats(n: int, in_offset: int, n_in: int, out_start: int,
                 n_out: int, device: str):
    """The matrices as the kernel reads them, K-major and split, one
    (ana^T, syn^T) pair for each chunk of `spectrum_chunks(n)`: ana^T
    [2 NA, kp] (hi rows, then lo rows) from the input window's analysis
    rows, and syn^T [2 s_rows, NA] from the output window's synthesis
    columns; the chunk's spectrum interleaved, K rows in `slice_order`,
    zero-padded to NA, kp = n_in and s_rows = n_out rounded up to 8 and
    to PASS."""
    ana, syn = _mats(n, device)
    nf = n // 2 + 1
    kp, s_rows = _round_up(n_in, 8), _round_up(n_out, PASS)
    ana = _interleave(ana, nf, 1)[in_offset:in_offset + n_in]
    syn = _interleave(syn, nf, 0)[:, out_start:out_start + n_out]
    pairs = []
    for k0 in spectrum_chunks(n):
        cols = slice(2 * k0, min(2 * nf, 2 * k0 + NA))
        width = cols.stop - cols.start
        a = torch.zeros((kp, NA), device=device)
        a[:n_in, :width] = ana[:, cols]
        b = torch.zeros((NA, s_rows), device=device)
        b[:width, :n_out] = syn[cols]
        a = a[slice_order(kp).to(device)].t()
        b = b[slice_order(NA).to(device)].t()
        pairs.append((torch.cat(tf32_split(a)).contiguous(),
                      torch.cat(tf32_split(b)).contiguous()))
    return tuple(pairs)


def frac_shift_plain(x, shift, n: int, in_offset: int, out_window):
    """Plain PyTorch version: the two products of sep_warp._frac_shift_impl
    in float32.  x [R, n_in], shift [R] -> [R, out_window[1]] float32."""
    n_in = x.shape[-1]
    nf = n // 2 + 1
    ana, syn = _mats(n, str(x.device))
    ana = ana[in_offset:in_offset + n_in]
    syn = syn[:, out_window[0]:out_window[0] + out_window[1]]
    f = torch.matmul(x.float(), ana)
    k = torch.arange(nf, dtype=torch.float32, device=x.device)
    phi = -2.0 * np.pi * k * shift.float()[:, None] / n
    c, s = torch.cos(phi), torch.sin(phi)
    fr, fi = f[:, :nf], f[:, nf:]
    g = torch.cat([fr * c - fi * s, fr * s + fi * c], dim=-1)
    return torch.matmul(g, syn)


def frac_shift_kernel(x, shift, n: int, in_offset: int, out_window):
    """Launch the kernel, once for each spectrum chunk (one count):
    [R, out_window[1]] float32."""
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError("frac_shift kernel takes a float32 [R, n_in] tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    rows, n_in = x.shape
    if shift.shape != (rows,) or shift.device != x.device:
        raise ValueError(f"frac_shift needs one shift per row on x's device, "
                         f"got {tuple(shift.shape)} on {shift.device}")
    start, size = out_window
    if in_offset < 0 or in_offset + n_in > n or start < 0 or start + size > n:
        raise ValueError(f"frac_shift windows ({in_offset}, {n_in}) / "
                         f"{tuple(out_window)} leave the length {n}")
    lib = kernels.library("shift", _SIGNATURES)
    # TMA reads x by rows of a multiple of 16 bytes
    x = x.contiguous()
    if n_in % 4:
        x = torch.nn.functional.pad(x, (0, 4 - n_in % 4))
    x = kernels.aligned(x)
    shift = shift.float().contiguous()
    mats = _kernel_mats(n, in_offset, n_in, start, size, str(x.device))
    out = torch.empty((rows, size), dtype=torch.float32, device=x.device)
    # the first chunk writes out, the later ones add to it
    for k0, (ana, syn) in zip(spectrum_chunks(n), mats):
        code = lib.frac_shift(x.data_ptr(), shift.data_ptr(), ana.data_ptr(),
                              syn.data_ptr(), out.data_ptr(), rows,
                              x.shape[1], n_in, n, k0, ana.shape[1],
                              syn.shape[0] // 2, size, kernels.stream_ptr(x))
        kernels.check(lib, code, "frac_shift")
    kernels.LAUNCHES["frac_shift"] += 1
    return out


def tf32_product_probe(a, b):
    """The kernel's tf32 wgmma alone, for the card tests: a [64, k] . b
    [k, N] (k a multiple of 8, N = 112 or 232) as one tf32 product
    with b K-major in `slice_order`, brought in by TMA as the kernel's
    matrices are.  float32 [64, N]."""
    k, width = b.shape
    if a.shape != (64, k) or a.dtype != torch.float32 or not a.is_cuda:
        raise TypeError("tf32 probe takes a float32 CUDA a [64, k]")
    lib = kernels.library("shift", _SIGNATURES)
    a = kernels.aligned(a)
    bt = b.float()[slice_order(k).to(b.device)].t().contiguous()
    c = torch.empty((64, width), dtype=torch.float32, device=a.device)
    code = lib.tf32_probe(a.data_ptr(), bt.data_ptr(), c.data_ptr(), k,
                          width, kernels.stream_ptr(a))
    kernels.check(lib, code, "tf32_probe")
    return c


class _FracShiftFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, n, in_offset, out_window):
        ctx.save_for_backward(shift)
        ctx.geom = (n, in_offset, tuple(out_window), x.shape[-1])
        return frac_shift_kernel(x, shift, n, in_offset, out_window)

    @staticmethod
    def backward(ctx, g):
        (shift,) = ctx.saved_tensors
        n, in_offset, out_window, in_size = ctx.geom
        # the cotangent lives on the forward's output window and lands on
        # its input window, with the phase negated
        gx = frac_shift_kernel(g.float(), -shift, n, out_window[0],
                               (in_offset, in_size))
        return gx, None, None, None, None


def frac_shift_last(x, shift, n: int, in_offset: int = 0, out_window=None):
    """Shift the rows of x [R, n_in] by shift [R]; float32 [R, size] out.
    CUDA tensors launch the kernel; CPU tensors run `frac_shift_plain`."""
    out_window = tuple(out_window or (0, n))
    x = x.float()
    if x.is_cuda:
        return _FracShiftFn.apply(x, shift.float(), n, in_offset, out_window)
    if x.device.type == "cpu":
        return frac_shift_plain(x, shift, n, in_offset, out_window)
    raise RuntimeError(f"frac_shift has no kernel for device {x.device}")
