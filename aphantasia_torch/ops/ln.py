"""Row LayerNorm as a hand-written CUDA kernel pair (csrc/ln.cu), with its
plain PyTorch version beside it (counterpart of
aphantasia_tpu.ops.pallas_ln).

    fwd: y = (x - mu) * rsqrt(var + eps) * g + b, saving (mu, rstd) [R,2]
    bwd: dx = rstd * (h - mean(h) - xhat * mean(h * xhat)), h = g * dy,
         dg = sum(dy * xhat), db = sum(dy)

with one-pass float32 moments (var = E[x^2] - E[x]^2), y and dx in x's
dtype and dy cast to x's dtype first.  It replaces the Pallas kernels
`_ln_fwd` (pallas_call at pallas_ln.py:88) and `_ln_bwd` (:114).  The
backward is complete (dx, dg, db) although the CLIP towers are frozen, as
the TPU kernel's is.

`layer_norm_fused` launches the kernels for CUDA tensors and runs the
plain versions for CPU tensors; anything else raises.  `eligible` is the
JAX package's gate: 2-D activations, a width that is a multiple of 128,
and at least 1024 rows.
"""
from __future__ import annotations

import torch

from aphantasia_torch import kernels

_BR = 512          # the TPU kernel's row block; the gate asks for two
_BWD_ROWS = 16     # rows per block of the CUDA backward's first launch

_SIGNATURES = {
    "ln_fwd": [kernels.PTR] * 5 + [kernels.INT] * 2 + [kernels.FLOAT,
                                                       kernels.INT,
                                                       kernels.PTR],
    "ln_bwd": [kernels.PTR] * 8 + [kernels.INT] * 4 + [kernels.PTR],
}


def eligible(x, g) -> bool:
    """2-D activations, a lane-multiple width, enough rows to amortize."""
    return (x.ndim == 2 and g.ndim == 1 and x.shape[1] % 128 == 0
            and x.shape[0] >= 2 * _BR)


def ln_fwd_plain(x, g, b, eps=1e-5):
    """Plain PyTorch forward: (y in x's dtype, stat [R,2] float32)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd * g.float() + b.float()
    return y.to(x.dtype), torch.cat([mu, rstd], 1)


def ln_bwd_plain(x, g, stat, dy):
    """Plain PyTorch backward: (dx in x's dtype, dg, db float32 [D])."""
    xf = x.float()
    mu, rstd = stat[:, 0:1], stat[:, 1:2]
    xhat = (xf - mu) * rstd
    dyf = dy.to(x.dtype).float()
    h = dyf * g.float()
    m1 = h.mean(-1, keepdim=True)
    m2 = (h * xhat).mean(-1, keepdim=True)
    dx = ((h - m1 - xhat * m2) * rstd).to(x.dtype)
    return dx, (dyf * xhat).sum(0), dyf.sum(0)


def _check(x, g):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 2:
        raise TypeError("layer norm kernel takes a bf16/float32 [R, D] "
                        f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] % 8 or tuple(g.shape) != (x.shape[1],):
        raise ValueError(f"layer norm kernel needs D % 8 == 0 and a gain of "
                         f"[D]; got x {tuple(x.shape)}, g {tuple(g.shape)}")


def ln_fwd_kernel(x, g, b, eps=1e-5):
    """Launch the forward kernel: (y in x's dtype, stat [R,2] float32)."""
    _check(x, g)
    rows, d = x.shape
    x = kernels.aligned(x)
    g = kernels.aligned(g.float())
    b = kernels.aligned(b.float())
    y = torch.empty_like(x)
    stat = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    lib = kernels.library("ln", _SIGNATURES)
    code = lib.ln_fwd(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                      stat.data_ptr(), rows, d, float(eps),
                      int(x.dtype == torch.bfloat16), kernels.stream_ptr(x))
    kernels.check(lib, code, "ln_fwd")
    kernels.LAUNCHES["ln_fwd"] += 1
    return y, stat


def ln_bwd_kernel(x, g, stat, dy):
    """Launch the backward kernels: (dx in x's dtype, dg, db float32 [D]).
    Both launches are one call, counted once under `ln_bwd`."""
    _check(x, g)
    rows, d = x.shape
    if tuple(stat.shape) != (rows, 2) or tuple(dy.shape) != (rows, d):
        raise ValueError(f"layer norm backward: stat {tuple(stat.shape)} / "
                         f"dy {tuple(dy.shape)} do not fit x {(rows, d)}")
    x = kernels.aligned(x)
    dy = kernels.aligned(dy.to(x.dtype))
    g = kernels.aligned(g.float())
    stat = stat.float().contiguous()
    nblk = -(-rows // _BWD_ROWS)
    dx = torch.empty_like(x)
    part = torch.empty((2, nblk, d), dtype=torch.float32, device=x.device)
    dg = torch.empty((d,), dtype=torch.float32, device=x.device)
    db = torch.empty((d,), dtype=torch.float32, device=x.device)
    lib = kernels.library("ln", _SIGNATURES)
    code = lib.ln_bwd(x.data_ptr(), g.data_ptr(), stat.data_ptr(),
                      dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
                      dg.data_ptr(), db.data_ptr(), rows, d, _BWD_ROWS,
                      int(x.dtype == torch.bfloat16), kernels.stream_ptr(x))
    kernels.check(lib, code, "ln_bwd")
    kernels.LAUNCHES["ln_bwd"] += 1
    return dx, dg, db


def _device_fn(x, kernel, plain):
    if x.is_cuda:
        return kernel
    if x.device.type == "cpu":
        return plain
    raise RuntimeError(f"layer norm has no kernel for device {x.device}")


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, stat = _device_fn(x, ln_fwd_kernel, ln_fwd_plain)(x, g, b, eps)
        ctx.save_for_backward(x, g, stat)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, stat = ctx.saved_tensors
        dx, dg, db = _device_fn(x, ln_bwd_kernel, ln_bwd_plain)(x, g, stat,
                                                                dy)
        return dx, dg.to(g.dtype), db.to(ctx.b_dtype), None


def layer_norm_fused(x, g, b, eps=1e-5):
    """LayerNorm over the last axis of x [R, D] with the closed-form
    backward.  CUDA tensors launch the kernels; CPU tensors run the plain
    versions."""
    return _LayerNormFn.apply(x, g, b, eps)
