"""Fused ViT residual-block halves as hand-written CUDA kernels
(csrc/block.cu), with their plain PyTorch versions beside them
(counterpart of aphantasia_tpu.ops.pallas_block).

    attn_half: y = x + out_proj(attention(qkv_proj(LN1(x))))
    mlp_half:  y = x + proj(quick_gelu(fc(LN2(x))))

over the flat sample-major stream x [R, D], R = b*t.  The backward of each
half is closed-form and gives dx only: the CLIP towers are frozen, so every
weight gets None (the JAX custom_vjp returns zeros).  It recomputes the
forward pieces from x and, for the attention, the saved log-sum-exps `lse`
[R, n_heads] float32.

Both versions round where the TPU kernels (pallas_call at
pallas_block.py:273, :298, :333, :358) round, with `dt` the dtype of x:
- LN: one-pass float32 moments, h = xhat * g + b rounded to dt;
- a product: dt operands summed in float32, rounded to dt, then the bias
  added in dt; the residual add in dt;
- attention: s = q k^T / sqrt(hd) in float32, c = k ln 2 with k =
  floor(rowmax(s) / ln 2), e = exp(s - c), lse = c + log(sum(e)),
  o = (round_dt(e) @ v) / sum(e): an exact softmax, no clamp, e < 2.  The
  TPU kernel clamps (e = exp(min(s, 60)), nothing subtracted) and saves
  1 / sum(e); the two agree wherever no score passes 60, and since c
  shifts e by a power of two, round_dt(e) is the TPU kernel's rounding
  scaled (`_shift`);
- attention backward: p32 = exp(s - lse), dv = round_dt(p32)^T do,
  ds = round_dt(p32 (dp - sum(dp p32)) / sqrt(hd)); dh = dqkv @ in_w^T
  stays float32 into the LN backward;
- MLP backward: da = dy @ p_w^T stays float32, du = round_dt(da * gelu'(u)),
  dh = du @ fc_w^T in float32;
- dx = dy + round_dt(LN-backward(dh)), added in dt.

The JAX package merges `bb` samples into one row block with a cross-sample
mask (`_merged_bias`), pads rows to the block (`_pad_rows`), caps the MLP
block at 128 rows and splits the backward into quarters: all of that is
tiling for the TPU's VMEM.  The CUDA kernels work per row and per
(sample, head), so none of it exists here; `flat_geometry` is kept only to
decide *whether* the fused path is taken, so that the same configurations
take it in both packages.

`attn_half` / `mlp_half` launch the kernels for CUDA tensors and run the
plain versions for CPU tensors; anything else raises.
"""
from __future__ import annotations

import math

import torch

from aphantasia_torch import kernels

_P, _I, _F = kernels.PTR, kernels.INT, kernels.FLOAT
_SIGNATURES = {
    "attn_half_fwd": [_P] * 12 + [_I] * 4 + [_F, _I, _P],
    "attn_half_bwd": [_P] * 16 + [_I] * 4 + [_F, _I, _P],
    "mlp_half_fwd": [_P] * 10 + [_I] * 4 + [_P],
    "mlp_half_bwd": [_P] * 13 + [_I] * 4 + [_P],
    "block_product": [_P] * 5 + [_I] * 5 + [_P],
    "block_core_fwd": [_P] * 3 + [_I] * 4 + [_F, _P],
    "block_core_bwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    "block_smem_bytes": [_I, _I, _I],
}
_SMEM_LIMIT = 232448
_TC_HEAD = 64       # the widest head of the bf16 tensor-core core
_EPS = 1e-5
_ROW_TARGET = 256   # the JAX geometry's default row target
_LN2, _INV_LN2 = 0.6931471805599453, 1.4426950408889634


def flat_geometry(t: int, dtype):
    """The JAX gate (pallas_attn.flat_geometry at its default row target):
    samples per TPU block, or None where the alignment would force blocks
    above 1024 rows.  Here it only decides whether the fused path runs."""
    tile = 16 if dtype == torch.bfloat16 else 8
    bb = 1
    while (bb * t) % tile != 0:
        bb += 1
    while bb * t < _ROW_TARGET:
        bb *= 2
    if bb * t > max(1024, _ROW_TARGET):
        return None
    return bb


# ------------------------------------------------------------ plain versions

def _ln(x, g, b):
    """(h in x's dtype, xhat, inv) with one-pass float32 moments."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + _EPS)
    xhat = (xf - mu) * inv
    return (xhat * g.float() + b.float()).to(x.dtype), xhat, inv


def _ln_bwd(dh, g, xhat, inv, dtype):
    """dx of h = xhat * g + b given a float32 dh, rounded to `dtype`."""
    dxhat = dh * g.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return ((dxhat - m1 - xhat * m2) * inv).to(dtype)


def _mm(a, w):
    """a @ w: operands in their dtype, the sum in float32."""
    return a.float() @ w.float()


def _mm_t(a, w):
    """a @ w^T, the sum in float32."""
    return a.float() @ w.float().t()


def _mm_bias(a, w, b):
    """a @ w rounded to a's dtype, then the bias added in that dtype."""
    return _mm(a, w).to(a.dtype) + b.to(a.dtype)


def _split(qkv, n_heads, t):
    """[R, 3D] -> q, k, v [b, t, heads, hd]."""
    r, d3 = qkv.shape
    d = d3 // 3
    return qkv.reshape(r // t, t, 3, n_heads, d // n_heads).unbind(2)


def _shift(m):
    """c = k ln 2, k = floor(m / ln 2), each product rounded to float32:
    the softmax's shift for the row max m.  exp(s - c) is exp(s) times
    2^-k, so its roundings to bf16 are those of the unshifted exp(s)
    (to a float32 ulp of s - c), and it stays below 2."""
    return torch.floor(m * _INV_LN2) * _LN2


def _scores(q, k, hd):
    """s = q k^T / sqrt(hd) [b, heads, q, k] float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s * (1.0 / math.sqrt(hd))


def _attn_core_fwd(qkv, n_heads, t):
    """(o [R, D] in qkv's dtype, lse [R, heads] float32)."""
    r, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    q, k, v = _split(qkv, n_heads, t)
    s = _scores(q, k, hd)
    c = _shift(s.amax(-1, keepdim=True))                       # [b,h,q,1]
    e = torch.exp(s - c)
    total = e.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(qkv.dtype).float(), v.float())
    o = o * (1.0 / total).permute(0, 2, 1, 3)
    lse = c + torch.log(total)
    return (o.reshape(r, d3 // 3).to(qkv.dtype),
            lse[..., 0].permute(0, 2, 1).reshape(r, n_heads))


def _attn_core_bwd(qkv, do, lse, n_heads, t):
    """dqkv [R, 3D] in qkv's dtype from do [R, D] and the saved lse."""
    r, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    dt = qkv.dtype
    q, k, v = _split(qkv, n_heads, t)
    do4 = do.reshape(r // t, t, n_heads, hd).float()
    lse4 = lse.reshape(r // t, t, n_heads).permute(0, 2, 1)[..., None]
    p32 = torch.exp(_scores(q, k, hd) - lse4)
    dv = torch.einsum("bhqk,bqhd->bkhd", p32.to(dt).float(), do4)
    dp = torch.einsum("bqhd,bkhd->bhqk", do4, v.float())
    ds = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    ds = (ds * (1.0 / math.sqrt(hd))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return torch.stack([dq, dk, dv], 2).reshape(r, d3).to(dt)


def attn_half_fwd_plain(x, g, b, in_w, in_b, out_w, out_b, n_heads, t):
    """Plain forward: (y in x's dtype, lse [R, n_heads] float32)."""
    dt = x.dtype
    h, _, _ = _ln(x, g, b)
    o, lse = _attn_core_fwd(_mm_bias(h, in_w.to(dt), in_b), n_heads, t)
    return x + _mm_bias(o, out_w.to(dt), out_b), lse


def attn_half_bwd_plain(x, dy, lse, g, b, in_w, in_b, out_w, n_heads, t):
    """Plain closed-form backward: dx in x's dtype."""
    dt = x.dtype
    dy = dy.to(dt)
    h, xhat, rstd = _ln(x, g, b)
    qkv = _mm_bias(h, in_w.to(dt), in_b)
    do = _mm_t(dy, out_w.to(dt)).to(dt)
    dh = _mm_t(_attn_core_bwd(qkv, do, lse, n_heads, t), in_w.to(dt))
    return dy + _ln_bwd(dh, g, xhat, rstd, dt)


def mlp_half_fwd_plain(x, g, b, fc_w, fc_b, p_w, p_b):
    """Plain forward: y in x's dtype."""
    dt = x.dtype
    h, _, _ = _ln(x, g, b)
    u = _mm_bias(h, fc_w.to(dt), fc_b).float()
    a = (u * torch.sigmoid(1.702 * u)).to(dt)
    return x + _mm_bias(a, p_w.to(dt), p_b)


def mlp_half_bwd_plain(x, dy, g, b, fc_w, fc_b, p_w):
    """Plain closed-form backward: dx in x's dtype."""
    dt = x.dtype
    dy = dy.to(dt)
    h, xhat, rstd = _ln(x, g, b)
    u = _mm_bias(h, fc_w.to(dt), fc_b).float()
    s = torch.sigmoid(1.702 * u)
    da = _mm_t(dy, p_w.to(dt))
    du = (da * (s + 1.702 * u * s * (1.0 - s))).to(dt)
    dh = _mm_t(du, fc_w.to(dt))
    return dy + _ln_bwd(dh, g, xhat, rstd, dt)


# ------------------------------------------------------------ kernel wrappers

def _check(x, n_heads=None, t=None, what="block"):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 2:
        raise TypeError("block kernels take a bf16/float32 [R, D] stream, "
                        f"got {x.dtype} {tuple(x.shape)}")
    r, d = x.shape
    if d % 8:
        raise ValueError(f"block kernels need D % 8 == 0, got D={d}")
    if n_heads is not None and (d % n_heads or r % t):
        raise ValueError(f"block: [R={r}, D={d}] does not split into "
                         f"{n_heads} heads and samples of t={t}")
    if (n_heads is not None and x.dtype == torch.bfloat16
            and d // n_heads > _TC_HEAD):
        raise ValueError(f"{what}: the bf16 core takes heads up to "
                         f"{_TC_HEAD} wide, got {d // n_heads}")


def _weights(x, named):
    """Each (name, tensor, shape): checked for its shape and x's device,
    cast to x's dtype (LN gain and bias: float32), contiguous and 16-byte
    aligned."""
    out = []
    for name, w, shape in named:
        if tuple(w.shape) != shape or w.device != x.device:
            raise ValueError(f"block: {name} is {tuple(w.shape)} on "
                             f"{w.device}, expected {shape} on {x.device}")
        w = w.float() if name in ("g", "b") else w.to(x.dtype)
        out.append(kernels.aligned(w))
    return out


def _smem_ok(lib, t, hd, backward):
    """float32's scalar attention cores hold two [t, hd] float32 matrices
    in shared memory: refuse what exceeds it."""
    need = lib.block_smem_bytes(t, hd, int(backward))
    if need > _SMEM_LIMIT:
        raise ValueError(f"block attention needs {need} bytes of shared "
                         f"memory at t={t}, hd={hd}; the limit is "
                         f"{_SMEM_LIMIT}")


def _attn_weights(x, g, b, in_w, in_b, out_w):
    d = x.shape[1]
    return _weights(x, (("g", g, (d,)), ("b", b, (d,)),
                        ("in_w", in_w, (d, 3 * d)), ("in_b", in_b, (3 * d,)),
                        ("out_w", out_w, (d, d))))


def _mlp_weights(x, g, b, fc_w, fc_b, p_w):
    d = x.shape[1]
    hidden = fc_w.shape[-1]
    if hidden % 8:
        raise ValueError(f"block: the MLP width {hidden} is not a multiple "
                         "of 8")
    return _weights(x, (("g", g, (d,)), ("b", b, (d,)),
                        ("fc_w", fc_w, (d, hidden)),
                        ("fc_b", fc_b, (hidden,)),
                        ("p_w", p_w, (hidden, d)))), hidden


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _empty(x, *shape, dtype=None):
    return torch.empty(shape, dtype=dtype or x.dtype, device=x.device)


def attn_half_fwd_kernel(x, g, b, in_w, in_b, out_w, out_b, n_heads, t):
    """Launch the attention half's forward: (y in x's dtype, lse
    [R, n_heads] float32).  Its four launches are counted once."""
    _check(x, n_heads=n_heads, t=t, what="block attention forward")
    r, d = x.shape
    x = kernels.aligned(x)
    ws = _attn_weights(x, g, b, in_w, in_b, out_w)
    (out_b,) = _weights(x, (("out_b", out_b, (d,)),))
    lib = kernels.library("block", _SIGNATURES)
    if x.dtype != torch.bfloat16:
        _smem_ok(lib, t, d // n_heads, backward=False)
    h, o, y = _empty(x, r, d), _empty(x, r, d), _empty(x, r, d)
    qkv = _empty(x, r, 3 * d)
    lse = _empty(x, r, n_heads, dtype=torch.float32)
    code = lib.attn_half_fwd(*_ptrs(x, *ws, out_b, h, qkv, o, y, lse), r, d,
                             n_heads, t, 1.0 / math.sqrt(d // n_heads),
                             int(x.dtype == torch.bfloat16),
                             kernels.stream_ptr(x))
    kernels.check(lib, code, "block_attn_fwd")
    kernels.LAUNCHES["block_attn_fwd"] += 1
    return y, lse


def attn_half_bwd_kernel(x, dy, lse, g, b, in_w, in_b, out_w, n_heads, t):
    """Launch the attention half's backward: dx in x's dtype.  Its six
    launches (seven in bf16 past t = 64, where the tensor-core core is
    two) are counted once."""
    _check(x, n_heads=n_heads, t=t, what="block attention backward")
    r, d = x.shape
    if (tuple(dy.shape) != (r, d) or tuple(lse.shape) != (r, n_heads)
            or dy.device != x.device or lse.device != x.device):
        raise ValueError(f"block attention backward: dy {tuple(dy.shape)} / "
                         f"lse {tuple(lse.shape)} do not fit x {(r, d)} on "
                         f"{x.device}")
    bf16 = x.dtype == torch.bfloat16
    x = kernels.aligned(x)
    dy = kernels.aligned(dy.to(x.dtype))
    lse = lse.float().contiguous()
    ws = _attn_weights(x, g, b, in_w, in_b, out_w)
    lib = kernels.library("block", _SIGNATURES)
    if not bf16:
        _smem_ok(lib, t, d // n_heads, backward=True)
    h, do, dx = _empty(x, r, d), _empty(x, r, d), _empty(x, r, d)
    qkv, dqkv = _empty(x, r, 3 * d), _empty(x, r, 3 * d)
    stat = _empty(x, r, 2, dtype=torch.float32)
    rs = _empty(x, r, n_heads, dtype=torch.float32)
    dh = _empty(x, r, d, dtype=torch.float32)
    code = lib.attn_half_bwd(*_ptrs(x, dy, lse, *ws, h, stat, qkv, do, dqkv,
                                    rs, dh, dx), r, d, n_heads, t,
                             1.0 / math.sqrt(d // n_heads),
                             int(bf16), kernels.stream_ptr(x))
    kernels.check(lib, code, "block_attn_bwd")
    kernels.LAUNCHES["block_attn_bwd"] += 1
    return dx


def mlp_half_fwd_kernel(x, g, b, fc_w, fc_b, p_w, p_b):
    """Launch the MLP half's forward: y in x's dtype.  Its three launches
    are counted once."""
    _check(x)
    r, d = x.shape
    x = kernels.aligned(x)
    ws, hidden = _mlp_weights(x, g, b, fc_w, fc_b, p_w)
    (p_b,) = _weights(x, (("p_b", p_b, (d,)),))
    lib = kernels.library("block", _SIGNATURES)
    h, y, a = _empty(x, r, d), _empty(x, r, d), _empty(x, r, hidden)
    code = lib.mlp_half_fwd(*_ptrs(x, *ws, p_b, h, a, y), r, d, hidden,
                            int(x.dtype == torch.bfloat16),
                            kernels.stream_ptr(x))
    kernels.check(lib, code, "block_mlp_fwd")
    kernels.LAUNCHES["block_mlp_fwd"] += 1
    return y


def mlp_half_bwd_kernel(x, dy, g, b, fc_w, fc_b, p_w):
    """Launch the MLP half's backward: dx in x's dtype.  Its five launches
    are counted once."""
    _check(x)
    r, d = x.shape
    if tuple(dy.shape) != (r, d) or dy.device != x.device:
        raise ValueError(f"block MLP backward: dy {tuple(dy.shape)} does not "
                         f"fit x {(r, d)} on {x.device}")
    x = kernels.aligned(x)
    dy = kernels.aligned(dy.to(x.dtype))
    ws, hidden = _mlp_weights(x, g, b, fc_w, fc_b, p_w)
    lib = kernels.library("block", _SIGNATURES)
    h, dx = _empty(x, r, d), _empty(x, r, d)
    u, du = _empty(x, r, hidden), _empty(x, r, hidden)
    stat = _empty(x, r, 2, dtype=torch.float32)
    dh = _empty(x, r, d, dtype=torch.float32)
    code = lib.mlp_half_bwd(*_ptrs(x, dy, *ws, h, stat, u, du, dh, dx), r, d,
                            hidden, int(x.dtype == torch.bfloat16),
                            kernels.stream_ptr(x))
    kernels.check(lib, code, "block_mlp_bwd")
    kernels.LAUNCHES["block_mlp_bwd"] += 1
    return dx


# The bf16 chains' launches one at a time (csrc/block.cu's block_product,
# block_core_fwd and block_core_bwd), for per-launch timing and checks on
# the card; the port's path reaches them only through the entry points.
# The product's epilogues (w [K, N] as stored, or [N, K] for the `@ w^T`
# kinds), with the plain version of each:
_PRODUCTS = {
    "bias": (0, lambda a, w, bias, aux: _mm_bias(a, w, bias)),
    "store": (1, lambda a, w, bias, aux: _mm_t(a, w).to(a.dtype)),
    "store_f32": (2, lambda a, w, bias, aux: _mm_t(a, w)),
    "gelu_back": (3, lambda a, w, bias, aux: _gelu_back(_mm_t(a, w), aux)),
    "bias_residual": (4, lambda a, w, bias, aux: aux + _mm_bias(a, w, bias)),
    "bias_gelu": (5, lambda a, w, bias, aux: _quick_gelu(_mm_bias(a, w,
                                                                   bias))),
}
_W_T = ("store", "store_f32", "gelu_back")       # w [N, K]
_NEEDS = {"bias": (True, False), "store": (False, False),
          "store_f32": (False, False), "gelu_back": (False, True),
          "bias_residual": (True, True), "bias_gelu": (True, False)}


def _quick_gelu(u):
    """round(u * sigmoid(1.702 u)), computed in float32."""
    uf = u.float()
    return (uf * torch.sigmoid(1.702 * uf)).to(u.dtype)


def _gelu_back(da, u):
    """round(da * gelu'(u)) for the quick_gelu u * sigmoid(1.702 u)."""
    uf = u.float()
    s = torch.sigmoid(1.702 * uf)
    return (da * (s + 1.702 * uf * s * (1.0 - s))).to(u.dtype)


def product_plain(a, w, kind, bias=None, aux=None):
    """The plain version of `product_kernel`."""
    return _PRODUCTS[kind][1](a, w, bias, aux)


def product_kernel(a, w, kind, bias=None, aux=None, width=None):
    """One product of the bf16 chains on wgmma: `kind` "bias" (a @ w +
    bias: qkv, u), "bias_residual" (aux + (a @ w + bias), aux the residual
    x [M, N]: out-proj, proj), "bias_gelu" (quick_gelu(a @ w + bias): fc),
    all with w [K, N]; "store" (a @ w^T, w [N, K]: do), "store_f32" (the
    same in float32: dh) or "gelu_back" (a @ w^T times gelu'(aux), aux = u
    [M, N]: du).  `width`: the tile width, 128 or 256, of the first three
    (None: 256).  bf16 CUDA tensors; counted as `block_product`."""
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or not a.is_cuda:
        raise TypeError("product_kernel takes bf16 CUDA tensors")
    m, k = a.shape
    n = w.shape[0] if kind in _W_T else w.shape[1]
    if w.shape[1 if kind in _W_T else 0] != k or k % 8 or n % 8:
        raise ValueError(f"product_kernel: a {tuple(a.shape)} and w "
                         f"{tuple(w.shape)} do not fit ({kind})")
    need_bias, need_aux = _NEEDS[kind]
    if ((bias is None) == need_bias or (aux is None) == need_aux
            or (need_bias and tuple(bias.shape) != (n,))
            or (need_aux and tuple(aux.shape) != (m, n))
            or width not in ((None,) if kind in _W_T else (None, 128, 256))):
        raise ValueError(f"product_kernel ({kind}): bias / aux / width "
                         f"{width} do not fit a [{m}, {n}] output")
    a, w = kernels.aligned(a), kernels.aligned(w)
    bias, aux = (None if v is None else kernels.aligned(v.to(torch.bfloat16))
                 for v in (bias, aux))
    out = _empty(a, m, n, dtype=torch.float32 if kind == "store_f32"
                 else torch.bfloat16)
    lib = kernels.library("block", _SIGNATURES)
    code = lib.block_product(
        a.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
        0 if aux is None else aux.data_ptr(), out.data_ptr(), m, n, k,
        _PRODUCTS[kind][0], width or 0, kernels.stream_ptr(a))
    kernels.check(lib, code, "block_product")
    kernels.LAUNCHES["block_product"] += 1
    return out


def _core_args(qkv, n_heads, t, what):
    r, d3 = qkv.shape
    if (qkv.dtype != torch.bfloat16 or not qkv.is_cuda
            or d3 // 3 // n_heads > _TC_HEAD or r % t):
        raise ValueError(f"{what} takes bf16 CUDA qkv with heads up to "
                         f"{_TC_HEAD} wide and R a multiple of t")
    return kernels.aligned(qkv), r, d3 // 3


def core_fwd_kernel(qkv, n_heads, t):
    """The bf16 attention core forward on the tensor cores (one launch,
    counted as `block_core_fwd`): (o [R, D] bf16, lse [R, heads] float32)
    from qkv [R, 3D]; plain version `_attn_core_fwd`."""
    qkv, r, d = _core_args(qkv, n_heads, t, "core_fwd_kernel")
    o = _empty(qkv, r, d)
    lse = _empty(qkv, r, n_heads, dtype=torch.float32)
    lib = kernels.library("block", _SIGNATURES)
    code = lib.block_core_fwd(*_ptrs(qkv, o, lse), r, t, n_heads, d,
                              1.0 / math.sqrt(d // n_heads),
                              kernels.stream_ptr(qkv))
    kernels.check(lib, code, "block_core_fwd")
    kernels.LAUNCHES["block_core_fwd"] += 1
    return o, lse


def core_bwd_kernel(qkv, do, lse, n_heads, t):
    """The bf16 attention core backward on the tensor cores (one launch
    for t <= 64, else two, counted once as `block_core_bwd`): dqkv [R, 3D]
    bf16 from qkv [R, 3D], do [R, D] bf16 and the forward's lse [R,
    heads]; plain version `_attn_core_bwd`."""
    qkv, r, d = _core_args(qkv, n_heads, t, "core_bwd_kernel")
    if do.dtype != torch.bfloat16:
        raise ValueError("core_bwd_kernel takes a bf16 do")
    do = kernels.aligned(do)
    lse = lse.float().contiguous()
    rs = _empty(qkv, r, n_heads, dtype=torch.float32)
    dqkv = _empty(qkv, r, 3 * d)
    lib = kernels.library("block", _SIGNATURES)
    code = lib.block_core_bwd(*_ptrs(qkv, do, lse, rs, dqkv), r, t, n_heads,
                              d, 1.0 / math.sqrt(d // n_heads),
                              kernels.stream_ptr(qkv))
    kernels.check(lib, code, "block_core_bwd")
    kernels.LAUNCHES["block_core_bwd"] += 1
    return dqkv


# ------------------------------------------------------------ autograd

def _device_fn(x, kernel, plain):
    if x.is_cuda:
        return kernel
    if x.device.type == "cpu":
        return plain
    raise RuntimeError(f"block halves have no kernel for device {x.device}")


class _AttnHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, in_w, in_b, out_w, out_b, n_heads, t):
        y, lse = _device_fn(x, attn_half_fwd_kernel, attn_half_fwd_plain)(
            x, g, b, in_w, in_b, out_w, out_b, n_heads, t)
        ctx.save_for_backward(x, lse, g, b, in_w, in_b, out_w)
        ctx.args = (n_heads, t)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, lse, *ws = ctx.saved_tensors
        dx = _device_fn(x, attn_half_bwd_kernel, attn_half_bwd_plain)(
            x, dy, lse, *ws, *ctx.args)
        return (dx,) + (None,) * 8


class _MlpHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, fc_w, fc_b, p_w, p_b):
        y = _device_fn(x, mlp_half_fwd_kernel, mlp_half_fwd_plain)(
            x, g, b, fc_w, fc_b, p_w, p_b)
        ctx.save_for_backward(x, g, b, fc_w, fc_b, p_w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        dx = _device_fn(x, mlp_half_bwd_kernel, mlp_half_bwd_plain)(
            x, dy, *ws)
        return (dx,) + (None,) * 6


def attn_half(x, g, b, in_w, in_b, out_w, out_b, n_heads, t):
    """x [R, D] (flat, sample-major, R = b*t) ->
    x + out_proj(attention(qkv_proj(LN(x)))); dx-only backward."""
    return _AttnHalf.apply(x, g, b, in_w, in_b, out_w, out_b, n_heads, t)


def mlp_half(x, g, b, fc_w, fc_b, p_w, p_b):
    """x [R, D] -> x + proj(quick_gelu(fc(LN(x)))); dx-only backward."""
    return _MlpHalf.apply(x, g, b, fc_w, fc_b, p_w, p_b)


def resblock_flat_fused(x, p, n_heads, t):
    """One ViT residual block over the flat stream as the two fused halves
    (parity target: models/clip/model.py:resblock_flat)."""
    a, m = p["attn"], p["mlp"]
    x = attn_half(x, p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"], a["in_b"],
                  a["out_w"], a["out_b"], n_heads, t)
    return mlp_half(x, p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"], m["fc_b"],
                    m["proj_w"], m["proj_b"])
