"""Multi-head attention core over the merged-qkv stream, as a hand-written
CUDA kernel pair (csrc/attention.cu), with its plain PyTorch version
beside it.

Counterpart of aphantasia_tpu/ops/pallas_attn.py: `attention_core_flat`
(the vision tower's flat [b*t, 3D] stream) and `attention_core` (the
[B, T, 3D] layout with `causal` and `valid_t`) keep their JAX signatures
and share one kernel, because the two layouts are the same memory.  The
JAX package pads tokens and merges samples to fit the TPU's tiles
(`flat_geometry`, `_pad_bt`, `_merged_bias`); the CUDA kernels tile each
(sample, head) at its real token count, so none of that exists here.

The kernel is chosen by dtype, once: bf16 runs the tensor-core tiles
(head width 64), float32 the FMA tiles (head width up to 128); both walk
keys in tiles of 64, so both take any token count.  `attention()`
launches the kernels for a CUDA tensor and runs `attention_plain` for a
CPU tensor; anything else raises.
"""
from __future__ import annotations

import math

import torch

from aphantasia_torch import kernels

_P, _I = kernels.PTR, kernels.INT
_SIGNATURES = {
    "attn_fwd": [_P, _P, _P] + [_I] * 7 + [_P],
    "attn_bwd": [_P] * 5 + [_I] * 7 + [_P],
}


def attention_plain(qkv, n_heads, t, causal=False, valid_t=None):
    """softmax(q k^T/sqrt(hd) + mask) v over [R, 3D] rows, R = b*t
    sample-major -> [R, D].  Keys j >= valid_t (and j > i when causal)
    are masked.  Differentiable through autograd."""
    r, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    b = r // t
    x = qkv.reshape(b, t, 3, n_heads, hd)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    keys = torch.arange(t, device=qkv.device)
    ok = (keys < (valid_t or t))[None, :].expand(t, t)
    if causal:
        ok = ok & (keys[None, :] <= keys[:, None])
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.reshape(r, d).to(qkv.dtype)


_BF16_HD = 64          # the head width of the bf16 tensor-core tiles
_F32_MAX_HD = 128      # the widest head the float32 tiles hold


def _check(qkv, n_heads, t, valid_t=None):
    if qkv.dtype not in (torch.float32, torch.bfloat16) or qkv.ndim != 2:
        raise TypeError("attention kernel takes a bf16/float32 [R, 3D] "
                        f"stream, got {qkv.dtype} {tuple(qkv.shape)}")
    r, d3 = qkv.shape
    if d3 % 3 or (d3 // 3) % n_heads or r % t:
        raise ValueError(f"attention: [R={r}, 3D={d3}] does not split into "
                         f"{n_heads} heads and samples of t={t}")
    if valid_t is not None and not 1 <= valid_t <= t:
        raise ValueError(f"attention: valid_t={valid_t} outside [1, {t}]")


def _fits(qkv, n_heads):
    """Refuse a head width the dtype's kernel does not take: the bf16
    tiles take 64 only, the float32 tiles up to 128.  Neither limits t."""
    hd = qkv.shape[1] // 3 // n_heads
    if qkv.dtype == torch.bfloat16 and hd != _BF16_HD:
        raise ValueError(f"bf16 attention kernel takes head width "
                         f"{_BF16_HD}, got {hd}")
    if qkv.dtype == torch.float32 and hd > _F32_MAX_HD:
        raise ValueError(f"float32 attention kernel takes head width up to "
                         f"{_F32_MAX_HD}, got {hd}")


def attention_fwd_kernel(qkv, n_heads, t, causal=False, valid_t=None):
    """Launch the forward kernel: (out [R, D] in qkv's dtype,
    lse [R, n_heads] float32)."""
    _check(qkv, n_heads, t, valid_t)
    qkv = kernels.aligned(qkv)
    r, d3 = qkv.shape
    d = d3 // 3
    _fits(qkv, n_heads)
    lib = kernels.library("attention", _SIGNATURES)
    out = torch.empty((r, d), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty((r, n_heads), device=qkv.device, dtype=torch.float32)
    code = lib.attn_fwd(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        r // t, t, n_heads, d, int(causal), int(valid_t or t),
                        int(qkv.dtype == torch.bfloat16),
                        kernels.stream_ptr(qkv))
    kernels.check(lib, code, "attn_fwd")
    kernels.LAUNCHES["attn_fwd"] += 1
    return out, lse


def attention_bwd_kernel(qkv, dout, out, lse, n_heads, t, causal=False,
                         valid_t=None):
    """Launch the backward kernel (two launches, dq then dk and dv,
    counted once): dqkv [R, 3D] in qkv's dtype."""
    _check(qkv, n_heads, t, valid_t)
    qkv = kernels.aligned(qkv)
    dout = kernels.aligned(dout.to(qkv.dtype))
    out = kernels.aligned(out.to(qkv.dtype))
    lse = lse.float().contiguous()
    r, d3 = qkv.shape
    d = d3 // 3
    _fits(qkv, n_heads)
    lib = kernels.library("attention", _SIGNATURES)
    dqkv = torch.empty_like(qkv)
    code = lib.attn_bwd(qkv.data_ptr(), dout.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), dqkv.data_ptr(), r // t, t, n_heads,
                        d, int(causal), int(valid_t or t),
                        int(qkv.dtype == torch.bfloat16),
                        kernels.stream_ptr(qkv))
    kernels.check(lib, code, "attn_bwd")
    kernels.LAUNCHES["attn_bwd"] += 1
    return dqkv


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_heads, t, causal, valid_t):
        out, lse = attention_fwd_kernel(qkv, n_heads, t, causal, valid_t)
        # `out` rides to the backward for rs = rowdot(do, o), the flash
        # identity that replaces a [t, t] row reduction
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (n_heads, t, causal, valid_t)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = attention_bwd_kernel(qkv, dout, out, lse, *ctx.args)
        return dqkv, None, None, None, None


def attention(qkv, n_heads, t, causal=False, valid_t=None):
    """[R, 3D] merged-qkv rows (R = b*t, sample-major) -> [R, D].
    CUDA tensors launch the kernels; CPU tensors run `attention_plain`."""
    if qkv.is_cuda:
        return _AttentionFn.apply(qkv, n_heads, t, causal, valid_t)
    if qkv.device.type == "cpu":
        return attention_plain(qkv, n_heads, t, causal, valid_t)
    raise RuntimeError(f"attention has no kernel for device {qkv.device}")


def attention_core_flat(qkv, n_heads, t, causal=False):
    """softmax(q k^T/sqrt(hd)) v over the flat sample-major stream
    [b*t, 3D] -> [b*t, D]."""
    return attention(qkv, n_heads, t, causal)


def attention_core(qkv, n_heads, causal=False, valid_t=None):
    """The same core over [B, T, 3D] -> [B, T, D]; `valid_t` key-masks
    rows >= valid_t of a caller-padded T."""
    b, t, d3 = qkv.shape
    out = attention(qkv.reshape(b * t, d3), n_heads, t, causal, valid_t)
    return out.reshape(b, t, d3 // 3)
