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

CUDA tensors launch the kernel; CPU tensors run `frac_shift_plain`;
anything else raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from aphantasia_torch import kernels

_SIGNATURES = {
    "frac_shift": [kernels.PTR] * 5 + [kernels.INT] * 6 + [kernels.PTR],
}


def _mats(n: int, device: str):
    """The packed float32 analysis [n, 2nf] and synthesis [2nf, n]."""
    from aphantasia_torch.ops.sep_warp import _packed_tensors
    return _packed_tensors(n, torch.float32, device)


def _round4(k: int) -> int:
    return -(-k // 4) * 4


@functools.lru_cache(maxsize=32)
def _kernel_mats(n: int, in_offset: int, n_in: int, out_start: int,
                 n_out: int, device: str):
    """The matrices as the kernel reads them: the analysis rows of the
    input window [n_in, lda] and the synthesis columns of the output window
    [2nf, lds], row-major and zero-padded to lda, lds = multiples of 4."""
    ana, syn = _mats(n, device)
    nc = ana.shape[1]
    a = torch.zeros((n_in, _round4(nc)), device=device)
    a[:, :nc] = ana[in_offset:in_offset + n_in]
    b = torch.zeros((nc, _round4(n_out)), device=device)
    b[:, :n_out] = syn[:, out_start:out_start + n_out]
    return a, b


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
    """Launch the kernel: [R, out_window[1]] float32."""
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
    x = x.contiguous()
    shift = shift.float().contiguous()
    ana, syn = _kernel_mats(n, in_offset, n_in, start, size, str(x.device))
    out = torch.empty((rows, size), dtype=torch.float32, device=x.device)
    code = lib.frac_shift(x.data_ptr(), shift.data_ptr(), ana.data_ptr(),
                          syn.data_ptr(), out.data_ptr(), rows, n_in, n,
                          ana.shape[1], size, syn.shape[1],
                          kernels.stream_ptr(x))
    kernels.check(lib, code, "frac_shift")
    kernels.LAUNCHES["frac_shift"] += 1
    return out


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
