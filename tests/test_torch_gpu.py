"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: float32 attention 2e-5 relative to the largest output (1e-4
on the gradient, float32 sum orders; 2e-5 at t = 577 and 1024); bf16 attention 2^-7 and five times
that on the gradient.  The bf16 tensor-core kernels round p to bf16
before p v and p, ds before the gradient products, as the TPU kernel
does, and the plain version does not: a rounding moves each term of
o = sum_j p_j v_j / l by at most 2^-9 p_j |v_j|, errors of random sign
over the row's keys, so the forward parts from the plain version by a
rounding step of the output (2^-8 relative) plus a sum of such terms
well inside it, as the card shows at every tested t; cutout
1e-5 forward (kernel and plain version round the frame, the weights and
the row pass to bf16 alike and sum each row's and column's distinct taps
in ascending frame index, so only the compiler's float32 arithmetic could
part them) and 1e-4 relative on the gradient (float32 sums in another
order than the plain version's); both kernels' own orders are fixed, so
they repeat bit for bit; perspective warp 1e-5 relative in float32 and 2^-7
in bf16, forward and gradient (the same float32 arithmetic, the gradient
summed in another order, each side rounding once); fractional shift 1e-4
relative (3xTF32 DFT products, float32's accuracy summed in another order
than cuBLAS's, which runs in full float32 here: allow_tf32 off); the tf32
product alone exact on small integers;
windowed cutout 1e-5 relative in float32 and 2^-7 in bf16 (both sides
sum in float32 and round the intermediate to bf16 once, so a sum near a
rounding boundary may round the other way: one bf16 step); LayerNorm
1e-5 relative in float32 and 2^-7 in bf16 on y and dx (one rounding of
the output each), 1e-5 relative on dg and db (float32 sums in another
order); fused half blocks 1e-4 relative in float32 (products summed in
another order through a chain of up to six) and 2^-6 in bf16 (both sides
round at the same points, but a sum in another order can flip an
intermediate rounding, which the output's own rounding may show again:
two bf16 steps), on y and dx, and 1e-5 on the attention's saved lse
(absolute: 1e-5 relative on its exp).  The ViT-B/32 tower's default
(fused) route holds a block to the unfused route at the same 2^-6.
"""
import itertools

import numpy as np
import pytest
import torch

from aphantasia_torch import kernels
from aphantasia_torch.ops import attention as A
from aphantasia_torch.ops import block as BL
from aphantasia_torch.ops import cutout as C
from aphantasia_torch.ops import cutout_win as W
from aphantasia_torch.ops import ln as L
from aphantasia_torch.ops import persp as P
from aphantasia_torch.ops import shift as SH
from aphantasia_torch.ops.perspective import (perspective_coeffs,
                                              perspective_endpoints,
                                              rotation_coeffs_for)
from aphantasia_torch.models.clip.model import cast_weights
from aphantasia_torch.ops.sampler import Boxes, CutoutSampler, _contract

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1.0)).item()


_SHAPES = [(50, 12, False, None), (77, 8, True, None), (64, 12, False, 50),
           (197, 12, False, None), (257, 16, False, None)]
# bf16 only: ragged and exact 64-row tiles, several key tiles with a
# valid_t inside the second
_BF16_SHAPES = [(63, 12, False, None), (64, 12, False, None),
                (65, 12, False, None), (129, 12, False, 100)]
# both kernels walk keys in tiles of 64, so both take any t: ViT-L/14@336px's
# 577 tokens, and 16 key tiles with valid_t inside the last; the float32
# gradient here is held at the forward's 2e-5
_LONG_SHAPES = [(577, 16, False, None), (1024, 8, False, 1000)]


@pytest.mark.parametrize("dtype,tol,gtol,t,heads,causal,valid_t", [
    (dtype, tol, 5 * tol) + shape
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -7))
    for shape in _SHAPES] + [
    (torch.bfloat16, 2 ** -7, 5 * 2 ** -7) + shape
    for shape in _BF16_SHAPES + _LONG_SHAPES] + [
    (torch.float32, 2e-5, 2e-5) + shape for shape in _LONG_SHAPES])
def test_attention_kernel_matches_plain(cuda, dtype, tol, gtol, t, heads,
                                        causal, valid_t):
    """bf16 runs the tensor-core tiles, float32 the FMA tiles."""
    b, d = 6, heads * 64
    qkv = torch.randn((b * t, 3 * d), generator=cuda, device="cuda").to(dtype)
    co = torch.randn((b * t, d), generator=cuda, device="cuda").to(dtype)
    before = kernels.LAUNCHES["attn_fwd"], kernels.LAUNCHES["attn_bwd"]
    qk = qkv.clone().requires_grad_(True)
    out = A.attention(qk, heads, t, causal, valid_t)
    (gk,) = torch.autograd.grad(out, qk, co)
    assert (kernels.LAUNCHES["attn_fwd"], kernels.LAUNCHES["attn_bwd"]) == (
        before[0] + 1, before[1] + 1)
    qp = qkv.clone().requires_grad_(True)
    ref = A.attention_plain(qp, heads, t, causal, valid_t)
    (gp,) = torch.autograd.grad(ref, qp, co)
    rows = (torch.arange(b * t, device="cuda") % t) < (valid_t or t)
    assert _rel(out[rows], ref[rows]) <= tol
    assert _rel(gk, gp) <= gtol


def _cutout_taps(cuda, h, w, s, m, align="uniform", edge=False,
                 full=False):
    """Taps of s crops from the sampler; `edge` pushes every crop against
    a frame edge (offset 0 or the largest) on each axis; `full` makes
    every crop the whole (square) frame."""
    sampler = CutoutSampler((h, w), s, m, align, 0.4, use_pallas=True)
    boxes = sampler.sample_boxes(cuda)
    if edge:
        hp, wp = sampler.padded_size
        low = torch.rand((2, s), generator=cuda, device="cuda") < 0.5
        boxes = Boxes(boxes.csize,
                      torch.where(low[0], 0, wp - boxes.csize).int(),
                      torch.where(low[1], 0, hp - boxes.csize).int())
    if full:
        zero = torch.zeros_like(boxes.offx)
        boxes = Boxes(torch.full_like(boxes.csize, min(h, w)), zero, zero)
    return sampler.tap_indices(boxes)


@pytest.mark.parametrize("h,w,s,m,align,edge,full", [
    pytest.param(720, 1280, 24, 224, "uniform", False, False,
                 id="720-1280-24-224"),
    pytest.param(40, 56, 6, 64, "uniform", False, False, id="40-56-6-64"),
    pytest.param(720, 1280, 24, 224, "overscan", False, False,
                 id="overscan"),
    pytest.param(720, 1280, 24, 224, "uniform", True, False,
                 id="edge-pushed"),
    pytest.param(40, 56, 6, 64, "overscan", True, False,
                 id="small-overscan-edge"),
    pytest.param(720, 1920, 24, 224, "uniform", False, False,
                 id="720-1920-24-224"),
    pytest.param(720, 1280, 95, 224, "overscan", False, False,
                 id="illustrip-720-1280-95-224-overscan"),
    pytest.param(512, 512, 47, 224, "overscan", False, False,
                 id="cppn-512-512-47-224-overscan"),
    pytest.param(512, 640, 190, 224, "uniform", False, False,
                 id="vqgan-512-640-190-224"),
    pytest.param(300, 300, 8, 224, "uniform", False, True,
                 id="whole-frame")])
def test_cutout_kernel_matches_plain(cuda, monkeypatch, h, w, s, m, align,
                                     edge, full):
    """Also a frame smaller than the crops (40x56 < 64): out-of-frame taps
    carry no weight; under overscan the tile maps fold the taps, so a
    crop reaches a tile from two places and the forward's span of frame
    columns is walked in pieces; crops that are the whole frame."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    taps = _cutout_taps(cuda, h, w, s, m, align, edge, full)
    img = torch.rand((3, h, w), generator=cuda, device="cuda",
                     requires_grad=True)
    co = torch.randn((s, 3, m, m), generator=cuda, device="cuda")
    out = C.cutout(img, *taps)
    (gk,) = torch.autograd.grad(out, img, co)
    ref = C.cutout_plain(img, *taps)
    (gp,) = torch.autograd.grad(ref, img, co)
    assert (out - ref).abs().max().item() <= 1e-5
    assert _rel(gk, gp) <= 1e-4


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("align", ["uniform", "overscan"])
def test_cutout_kernels_are_deterministic(cuda, kind, align):
    """Each kernel at 200 crops of 224 from 720x1280 gives the same bits
    on two launches and when captured into a CUDA graph and replayed (no
    atomics: each output is one sum in a fixed order); one count a
    call."""
    s, m = 200, 224
    taps = _cutout_taps(cuda, 720, 1280, s, m, align)
    if kind == "fwd":
        img = torch.rand((3, 720, 1280), generator=cuda, device="cuda")
        run = lambda: C.cutout_fwd_kernel(img, *taps)  # noqa: E731
    else:
        g = torch.randn((s, 3, m, m), generator=cuda, device="cuda")
        run = lambda: C.cutout_bwd_kernel(g, *taps,  # noqa: E731
                                          (3, 720, 1280))
    before = kernels.LAUNCHES["cutout_" + kind]
    a, b = run(), run()
    assert kernels.LAUNCHES["cutout_" + kind] == before + 2
    assert torch.equal(a, b)
    eager, replayed = _captured(run)
    assert torch.equal(eager, a) and torch.equal(replayed, a)


def _contract_taps(cuda, h, w, s, m, align="uniform", edge=False):
    """The default sampler's boxes and taps (`edge` as `_cutout_taps`)."""
    sampler = CutoutSampler((h, w), s, m, align, 0.4)
    boxes = sampler.sample_boxes(cuda)
    if edge:
        hp, wp = sampler.padded_size
        low = torch.rand((2, s), generator=cuda, device="cuda") < 0.5
        boxes = Boxes(boxes.csize,
                      torch.where(low[0], 0, wp - boxes.csize).int(),
                      torch.where(low[1], 0, hp - boxes.csize).int())
    return sampler, boxes


@pytest.mark.parametrize("h,w,s,m,align,edge", [
    pytest.param(720, 1280, 190, 224, "uniform", False, id="720p-190"),
    pytest.param(2160, 3840, 190, 224, "uniform", False, id="4k-190"),
    pytest.param(720, 1280, 95, 224, "overscan", False,
                 id="video-overscan-95"),
    pytest.param(480, 640, 190, 224, "uniform", False, id="480-640-190"),
    pytest.param(720, 1280, 38, 336, "uniform", False, id="720p-38-m336"),
    pytest.param(512, 512, 47, 224, "overscan", False,
                 id="h-first-512-512-47"),
    pytest.param(900, 600, 24, 224, "uniform", True,
                 id="h-first-900-600-edge"),
    pytest.param(720, 1280, 24, 224, "uniform", True, id="edge-pushed"),
    pytest.param(40, 56, 6, 64, "overscan", True,
                 id="crops-larger-than-the-frame")])
def test_contract_kernel_matches_plain(cuda, h, w, s, m, align, edge):
    """The default bf16 cut on the card (`sampler.cut`, the contraction
    kernel pair) against its plain version, bit for bit, forward and
    image gradient: both sum every term in the same order and round at
    the same points, and a product of two bf16 values is exact in
    float32.  The cells' shapes (W first), two frames that take H first,
    crops pushed against the frame's edges (their taps repeat an index)
    and crops larger than the frame; one count of each kernel a call."""
    sampler, boxes = _contract_taps(cuda, h, w, s, m, align, edge)
    img = torch.rand((1, 3, h, w), generator=cuda, device="cuda",
                     requires_grad=True)
    co = torch.randn((s, 3, m, m), generator=cuda, device="cuda")
    before = kernels.LAUNCHES.copy()
    out = sampler.cut(img, boxes, compute_dtype=torch.bfloat16)
    (gk,) = torch.autograd.grad(out, img, co)
    assert kernels.LAUNCHES - before == {"contract_fwd": 1,
                                         "contract_bwd": 1}
    x = img.detach()[0].requires_grad_(True)
    ref = C.contract_plain(x, *sampler.tap_indices(boxes))
    (gp,) = torch.autograd.grad(ref, x, co)
    assert torch.equal(out, ref)
    assert torch.equal(gk[0], gp)


@pytest.mark.parametrize("h,w,s,m,align,edge", [
    pytest.param(720, 1280, 190, 224, "uniform", False, id="720p-190"),
    pytest.param(512, 512, 47, 224, "overscan", False,
                 id="h-first-512-512-47"),
    pytest.param(900, 600, 24, 224, "uniform", True,
                 id="h-first-900-600-edge"),
    pytest.param(40, 56, 6, 64, "overscan", True,
                 id="crops-larger-than-the-frame")])
def test_contract_backward_tiles_of_64_match_plain(cuda, h, w, s, m, align,
                                                   edge):
    """The backward's tiles of 64, which only 4K-sized frames take by
    default, on the other shapes too: bit for bit the plain version (the
    tile side changes no sum's order), with tiles cut by the frame's edge
    on both axes."""
    sampler, boxes = _contract_taps(cuda, h, w, s, m, align, edge)
    taps = sampler.tap_indices(boxes)
    co = torch.randn((s, 3, m, m), generator=cuda, device="cuda")
    got = C.contract_bwd_kernel(co, *taps, (3, h, w), tile=64)
    assert torch.equal(got, C.contract_bwd_plain(co, *taps, (3, h, w)))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("h,w,align", [(720, 1280, "uniform"),
                                       (720, 1280, "overscan"),
                                       (512, 512, "overscan"),
                                       (2160, 3840, "uniform")])
def test_contract_kernels_are_deterministic(cuda, kind, h, w, align):
    """Each kernel at 190 crops of 224 gives the same bits on two launches
    and when captured into a CUDA graph and replayed twice (no atomics; at
    4K the backward's tiles of 64), one count a call."""
    s, m = 190, 224
    sampler, boxes = _contract_taps(cuda, h, w, s, m, align)
    taps = sampler.tap_indices(boxes)
    if kind == "fwd":
        img = torch.rand((3, h, w), generator=cuda, device="cuda")
        run = lambda: C.contract_fwd_kernel(img, *taps)  # noqa: E731
    else:
        g = torch.randn((s, 3, m, m), generator=cuda, device="cuda")
        run = lambda: C.contract_bwd_kernel(g, *taps,  # noqa: E731
                                            (3, h, w))
    before = kernels.LAUNCHES["contract_" + kind]
    a, b = run(), run()
    assert kernels.LAUNCHES["contract_" + kind] == before + 2
    assert torch.equal(a, b)
    graph = kernels.CountedGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    with graph.capture():
        out = run()
    before = kernels.LAUNCHES["contract_" + kind]
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, a)
    assert kernels.LAUNCHES["contract_" + kind] == before + 2


@pytest.mark.parametrize("h,w", [(720, 1280), (40, 56), (33, 97)])
def test_cutout_range_table_width_matches_the_plain_layout(cuda, h, w):
    """The library's table width, by which the wrapper sizes the range
    table, is the one `table_layout` (and so `tile_ranges`) lays out."""
    lib = kernels.library("cutout", C._SIGNATURES)
    assert lib.cutout_table_width(h, w) == C.table_layout(h, w)[2]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """float16 has no kernel; the float32 tiles hold heads up to 128 wide
    (and any t); the bf16 tiles take head width 64 only."""
    with pytest.raises(TypeError):
        A.attention(torch.zeros((10, 48), device="cuda",
                                dtype=torch.float16), 2, 5)
    with pytest.raises(ValueError, match="float32 .* up to 128"):
        A.attention_bwd_kernel(*(4 * [torch.zeros((2 * 420, 3 * 1024),
                                                  device="cuda")]), 4, 420)
    with pytest.raises(ValueError, match="head width"):
        A.attention_fwd_kernel(torch.zeros((2 * 50, 3 * 256), device="cuda",
                                           dtype=torch.bfloat16), 8, 50)


@pytest.mark.parametrize("t,heads,causal,valid_t", [
    (50, 12, False, None), (257, 16, False, None), (77, 8, True, None),
    (129, 12, False, 100)])
def test_bf16_attention_backward_is_deterministic(cuda, t, heads, causal,
                                                  valid_t):
    """No atomics, every sum in a fixed order: two backward launches give
    the same bits, and so do two forwards."""
    b, d = 4, heads * 64
    qkv = torch.randn((b * t, 3 * d), generator=cuda, device="cuda").to(
        torch.bfloat16)
    dout = torch.randn((b * t, d), generator=cuda, device="cuda").to(
        torch.bfloat16)
    out, lse = A.attention_fwd_kernel(qkv, heads, t, causal, valid_t)
    out2, lse2 = A.attention_fwd_kernel(qkv, heads, t, causal, valid_t)
    first = A.attention_bwd_kernel(qkv, dout, out, lse, heads, t, causal,
                                   valid_t)
    again = A.attention_bwd_kernel(qkv, dout, out, lse, heads, t, causal,
                                   valid_t)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(first, again)


def _persp_coeffs(kind, s, h, w, gen):
    if kind in ("persp", "persp-main"):
        start, end = perspective_endpoints(
            gen, s, h, w, 0.33, 0.2 if kind == "persp-main" else 0.5)
        flags = (end - start[None]).abs().amax((1, 2)) > 0
        return perspective_coeffs(start, end), flags.to(torch.int32)
    if kind == "rotate":
        ang = torch.linspace(-30.0, 30.0, s, device="cuda")
        ang[::4] = 0.0
        return rotation_coeffs_for(ang, h, w), (ang != 0).to(torch.int32)
    dw, dh = int(0.33 * (w // 2)), int(0.33 * (h // 2))
    los_his = [(0, dw), (0, dh), (w - dw - 1, w - 1), (0, dh),
               (w - dw - 1, w - 1), (h - dh - 1, h - 1),
               (0, dw), (h - dh - 1, h - 1)]
    pts = torch.tensor(list(itertools.product(*los_his)), dtype=torch.float32,
                       device="cuda")[::256 // s][:s]
    start = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                         dtype=torch.float32, device="cuda")
    return (perspective_coeffs(start, pts.reshape(s, 4, 2)),
            torch.ones((s,), dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("kind,h,w", [("persp", 224, 224),
                                      ("rotate", 224, 224),
                                      ("corners", 224, 224),
                                      ("persp", 40, 56),
                                      ("persp", 33, 97)])
def test_persp_kernels_match_plain(cuda, dtype, tol, kind, h, w):
    """Kernels A and B through the autograd wrapper: the extreme corner
    draws, +-30 deg rotations, a frame whose H is not a multiple of 16 and
    one whose W is not a multiple of a 16-byte run (scalar stores, and
    samples that do not start on 16 bytes); flag-0 samples are copied
    exactly both ways."""
    s = 16
    coef, flags = _persp_coeffs(kind, s, h, w, cuda)
    img = torch.rand((s, 3, h, w), generator=cuda, device="cuda").to(dtype)
    co = torch.randn((s, 3, h, w), generator=cuda, device="cuda").to(dtype)
    before = kernels.LAUNCHES["persp_fwd"], kernels.LAUNCHES["persp_bwd"]
    xk = img.clone().requires_grad_(True)
    out = P.perspective_warp(xk, coef, flags, family=(
        "rotate" if kind == "rotate" else "persp"))
    (gk,) = torch.autograd.grad(out, xk, co)
    assert (kernels.LAUNCHES["persp_fwd"], kernels.LAUNCHES["persp_bwd"]) == (
        before[0] + 1, before[1] + 1)
    xp = img.clone().requires_grad_(True)
    ref = P.perspective_warp_plain(xp, coef, flags)
    (gp,) = torch.autograd.grad(ref, xp, co)
    assert out.dtype == dtype and gk.dtype == dtype
    assert _rel(out, ref) <= tol and _rel(gk, gp) <= tol
    keep = flags == 0
    assert torch.equal(out[keep], img[keep]) and torch.equal(gk[keep], co[keep])


@pytest.mark.parametrize("kind", ["persp-main", "rotate"])
def test_persp_backward_is_deterministic(cuda, kind):
    """At the main path's [200, 3, 224, 224] bf16, the backward gives the
    same bits on two launches and when captured into a CUDA graph and
    replayed (a gather, no atomics: each pixel one sum in a fixed order),
    one count a call; both kernels copy the flag-0 samples exactly."""
    s = 200
    coef, flags = _persp_coeffs(kind, s, 224, 224, cuda)
    keep = flags == 0
    assert 0 < int(keep.sum()) < s
    img = torch.rand((s, 3, 224, 224), generator=cuda,
                     device="cuda").to(torch.bfloat16)
    g = torch.randn((s, 3, 224, 224), generator=cuda,
                    device="cuda").to(torch.bfloat16)
    before = kernels.LAUNCHES["persp_bwd"]
    a = P.persp_bwd_kernel(g, coef, flags)
    b = P.persp_bwd_kernel(g, coef, flags)
    assert kernels.LAUNCHES["persp_bwd"] == before + 2
    assert torch.equal(a, b) and torch.equal(a[keep], g[keep])
    eager, replayed = _captured(lambda: P.persp_bwd_kernel(g, coef, flags))
    assert torch.equal(eager, a) and torch.equal(replayed, a)
    out = P.persp_fwd_kernel(img, coef, flags)
    assert torch.equal(out[keep], img[keep])
    assert not torch.equal(out[~keep], img[~keep])


@pytest.mark.parametrize("rows,n_in,n,off,win", [
    (4096, 224, 224, 0, (0, 224)), (96, 16, 24, 4, (0, 24)),
    (96, 24, 24, 0, (4, 16)), (40, 12, 12, 0, (0, 12)),
    (1000, 20, 26, 3, (3, 17)), (300, 250, 250, 0, (0, 250)),
    (200, 336, 336, 0, (0, 336))])
def test_shift_kernel_matches_plain(cuda, monkeypatch, rows, n_in, n, off,
                                    win):
    """Kernel C forward, and its backward (the same kernel at -shift with
    the windows exchanged) against autograd's transpose of the plain
    version, in full float32.  Also rows, windows and an odd n_out that
    are no multiple of the tiles (the backward then reads rows of 17), and
    spectra past one product's 232 columns (two launches, the second
    adding to the first's output)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.randn((rows, n_in), generator=cuda, device="cuda")
    sh = (torch.rand((rows,), generator=cuda, device="cuda") * 2 - 1) * 6.0
    co = torch.randn((rows, win[1]), generator=cuda, device="cuda")
    before = kernels.LAUNCHES["frac_shift"]
    xk = x.clone().requires_grad_(True)
    out = SH.frac_shift_last(xk, sh, n, off, win)
    (gk,) = torch.autograd.grad(out, xk, co)
    assert kernels.LAUNCHES["frac_shift"] == before + 2
    xp = x.clone().requires_grad_(True)
    ref = SH.frac_shift_plain(xp, sh, n, off, win)
    (gp,) = torch.autograd.grad(ref, xp, co)
    assert _rel(out, ref) <= 1e-4 and _rel(gk, gp) <= 1e-4


@pytest.mark.parametrize("n", [112, 232])
@pytest.mark.parametrize("k", [8, 224])
def test_tf32_wgmma_product_is_exact_on_small_integers(cuda, monkeypatch, n,
                                                       k):
    """The tf32 wgmma with A from registers and B K-major through a
    32-byte-swizzled TMA box, in the slice order the shift kernel uses:
    bit for bit torch.matmul's (tf32 allowed) on integers in [-8, 8],
    whose products and sums float32 holds exactly."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a = torch.randint(-8, 9, (64, k), generator=cuda, device="cuda").float()
    b = torch.randint(-8, 9, (k, n), generator=cuda, device="cuda").float()
    assert torch.equal(SH.tf32_product_probe(a, b), a @ b)


def test_elastic_switch_routes_the_shift_through_the_kernel(cuda,
                                                            monkeypatch):
    from aphantasia_torch.ops.sep_warp import fractional_shift
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.rand((4, 3, 64, 64), generator=cuda, device="cuda")
    sh = torch.rand((4, 1, 64), generator=cuda, device="cuda") * 4 - 2
    plain = fractional_shift(x, sh, axis=-2)
    monkeypatch.setenv("APHANTASIA_PALLAS_SHIFT", "1")
    before = kernels.LAUNCHES["frac_shift"]
    got = fractional_shift(x, sh, axis=-2)
    assert kernels.LAUNCHES["frac_shift"] == before + 1
    assert _rel(got, plain) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("h,w,s,m,edge,nan", [
    (720, 1280, 24, 224, False, False), (200, 300, 12, 224, False, False),
    (96, 200, 16, 32, True, False), (720, 1280, 8, 336, False, False),
    (720, 1280, 24, 224, False, True)])
def test_windowed_cutout_kernel_matches_plain(cuda, dtype, tol, h, w, s, m,
                                              edge, nan):
    """The 720x1280 draw spans the three tiers; 300 and 200 columns are not
    multiples of 128 (the window reads zeros past W) and 300 is not one of
    8 (the TMA maps read a padded copy); `edge` pushes every box to the
    bottom-right corner, so the windows are clipped there; m = 336 takes
    two column tiles; `nan` hands the kernel an intermediate scratch
    filled with NaN, which it must overwrite wherever it reads it."""
    sampler = CutoutSampler((h, w), s, m, "uniform", 0.4)
    boxes = sampler.sample_boxes(cuda)
    if edge:
        boxes = Boxes(boxes.csize, w - boxes.csize, h - boxes.csize)
    img = torch.rand((3, h, w), generator=cuda, device="cuda").to(dtype)
    wyw, wxt = sampler.weight_matrices_windowed(boxes, dtype=dtype)
    before = kernels.LAUNCHES["win_cut_fwd"]
    if nan:
        kh_max = W.tier_plan(h, w, m)[-1][1]
        t1 = torch.full((s, 3, kh_max, m), float("nan"), dtype=dtype,
                        device="cuda")
        out = W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, m, dtype,
                                        t1=t1)
    else:
        out = W.windowed_cut_fwd(img, boxes, wyw, wxt, m, dtype)
    assert kernels.LAUNCHES["win_cut_fwd"] == before + 1
    ref = W.windowed_cut_fwd_plain(img, boxes, wyw, wxt, m, dtype)
    assert out.dtype == torch.float32 and out.shape == (s, 3, m, m)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) <= tol


def test_windowed_cutout_kernel_is_deterministic(cuda):
    """Two launches of the bf16 kernel on the same inputs give the same
    bits (no atomics: each output element is one block's sum)."""
    sampler = CutoutSampler((720, 1280), 24, 224, "uniform", 0.4)
    boxes = sampler.sample_boxes(cuda)
    img = torch.rand((3, 720, 1280), generator=cuda,
                     device="cuda").to(torch.bfloat16)
    wyw, wxt = sampler.weight_matrices_windowed(boxes, dtype=torch.bfloat16)
    a = W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, 224)
    b = W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, 224)
    assert torch.equal(a, b)


def _captured(fn):
    """fn() eagerly, then fn() captured into a CUDA graph and replayed:
    (eager result, replayed result).  A capture raises on a host sync or
    a pageable host-to-device copy inside fn."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, out


def test_windowed_cut_and_fused_layer_norm_capture_into_a_graph(
        cuda, monkeypatch):
    """A bf16 windowed `sampler.cut` (bases, weights, kernel) and a
    `layer_norm_fused` forward are captured into CUDA graphs, and their
    replays equal the eager calls bit for bit."""
    monkeypatch.setenv("APHANTASIA_WIN_CUTOUT", "1")
    sampler = CutoutSampler((720, 1280), 24, 224, "uniform", 0.4)
    boxes = sampler.sample_boxes(cuda)
    img = torch.rand((3, 720, 1280), generator=cuda, device="cuda")
    before = kernels.LAUNCHES["win_cut_fwd"]
    eager, replayed = _captured(
        lambda: sampler.cut(img, boxes, compute_dtype=torch.bfloat16))
    assert kernels.LAUNCHES["win_cut_fwd"] == before + 3
    assert torch.equal(eager, replayed)
    x = torch.randn((2048, 768), generator=cuda,
                    device="cuda").to(torch.bfloat16)
    g = torch.randn((768,), generator=cuda, device="cuda") + 1.0
    b = torch.randn((768,), generator=cuda, device="cuda") * 0.1
    eager, replayed = _captured(lambda: L.layer_norm_fused(x, g, b))
    assert torch.equal(eager, replayed)


def test_windowed_switch_routes_the_cut_through_the_kernel(cuda,
                                                           monkeypatch):
    """APHANTASIA_WIN_CUTOUT=1 sends a bf16 cut through the kernel; its
    gradient is the dense transpose, equal to the dense contraction's
    (`_contract`, which the card's default bf16 cut no longer runs)."""
    sampler = CutoutSampler((720, 1280), 16, 224, "uniform", 0.4)
    boxes = sampler.sample_boxes(cuda)
    img = torch.rand((3, 720, 1280), generator=cuda, device="cuda",
                     requires_grad=True)
    co = torch.randn((16, 3, 224, 224), generator=cuda, device="cuda")
    dense = _contract(img, *sampler.weight_matrices(
        boxes, dtype=torch.bfloat16), torch.bfloat16)
    (g_dense,) = torch.autograd.grad(dense, img, co)
    monkeypatch.setenv("APHANTASIA_WIN_CUTOUT", "1")
    before = kernels.LAUNCHES["win_cut_fwd"]
    win = sampler.cut(img, boxes, compute_dtype=torch.bfloat16)
    (g_win,) = torch.autograd.grad(win, img, co)
    assert kernels.LAUNCHES["win_cut_fwd"] == before + 1
    assert _rel(win, dense) <= 2 ** -7
    assert _rel(g_win, g_dense) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("rows,d", [(9500, 768), (1799, 1024), (1201, 256),
                                    (2048, 512), (1201, 1280), (1024, 128),
                                    (7, 128), (1201, 2048)])
def test_ln_kernels_match_plain(cuda, dtype, tol, rows, d):
    """Forward and backward through layer_norm_fused; 1201, 1799 and 7
    rows are not multiples of any block of the backward; 1024 is the
    gate's least; 2048 columns take the backward's general path (wider
    than its registers hold).  The backward is deterministic: a second run
    and a CUDA-graph replay give the same bits (its column sums add
    per-block partials in a fixed order, with no atomics)."""
    x = (torch.randn((rows, d), generator=cuda, device="cuda") * 2
         + 0.5).to(dtype)
    g = torch.randn((d,), generator=cuda, device="cuda") * 0.5 + 1.0
    b = torch.randn((d,), generator=cuda, device="cuda") * 0.1
    co = torch.randn((rows, d), generator=cuda, device="cuda").to(dtype)
    before = kernels.LAUNCHES["ln_fwd"], kernels.LAUNCHES["ln_bwd"]
    xk, gk, bk = (t.clone().requires_grad_(True) for t in (x, g, b))
    y = L.layer_norm_fused(xk, gk, bk)
    grads = torch.autograd.grad(y, (xk, gk, bk), co)
    assert (kernels.LAUNCHES["ln_fwd"], kernels.LAUNCHES["ln_bwd"]) == (
        before[0] + 1, before[1] + 1)
    yr, stat = L.ln_fwd_plain(x, g, b)
    ref = L.ln_bwd_plain(x, g, stat, co)
    assert y.dtype == dtype and grads[0].dtype == dtype
    assert _rel(y, yr) <= tol and _rel(grads[0], ref[0]) <= tol
    assert _rel(grads[1], ref[1]) <= 1e-5 and _rel(grads[2], ref[2]) <= 1e-5
    stat = L.ln_fwd_kernel(x, g, b)[1]
    again = L.ln_bwd_kernel(x, g, stat, co)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, grads))
    _, replayed = _captured(lambda: L.ln_bwd_kernel(x, g, stat, co))
    assert all(torch.equal(r, b_) for r, b_ in zip(replayed, grads))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1024, 256), device="cuda")
    g = torch.ones((256,), device="cuda")
    with pytest.raises(TypeError):
        L.ln_fwd_kernel(x.half(), g, g)
    with pytest.raises(ValueError):
        L.ln_fwd_kernel(torch.zeros((1024, 260), device="cuda"),
                        torch.ones((260,), device="cuda"),
                        torch.ones((260,), device="cuda"))
    with pytest.raises(ValueError):
        L.ln_bwd_kernel(x, g, torch.zeros((1000, 2), device="cuda"), x)
    sampler = CutoutSampler((96, 160), 4, 32, "uniform", 0.4)
    boxes = sampler.sample_boxes(cuda)
    img = torch.zeros((3, 96, 160), device="cuda")
    wyw, wxt = sampler.weight_matrices_windowed(boxes)
    with pytest.raises(TypeError):
        W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, 32, torch.float16)
    with pytest.raises(ValueError):
        W.windowed_cut_fwd_kernel(img, boxes, wyw[:, :, :8], wxt, 32,
                                  torch.float32)
    with pytest.raises(ValueError):   # a scratch that does not fit
        W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, 32, torch.bfloat16,
                                  t1=torch.empty((4, 3, 8, 32),
                                                 dtype=torch.bfloat16,
                                                 device="cuda"))


def _block(cuda, rows, d, dtype):
    """x, dy [rows, d] and one block's params at the `_block_init` scales
    with non-zero biases (g, b float32; the rest in `dtype`)."""
    def n(*shape, std=1.0):
        return torch.randn(shape, generator=cuda, device="cuda") * std

    def ln():
        return {"g": 1.0 + n(d, std=0.1), "b": n(d, std=0.1)}
    p = {"ln_1": ln(), "ln_2": ln(),
         "attn": {"in_w": n(d, 3 * d, std=d ** -0.5),
                  "in_b": n(3 * d, std=0.02),
                  "out_w": n(d, d, std=d ** -0.5), "out_b": n(d, std=0.02)},
         "mlp": {"fc_w": n(d, 4 * d, std=(2 * d) ** -0.5),
                 "fc_b": n(4 * d, std=0.02),
                 "proj_w": n(4 * d, d, std=d ** -0.5),
                 "proj_b": n(d, std=0.02)}}
    return n(rows, d).to(dtype), n(rows, d).to(dtype), cast_weights(p, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("rows,t,d,heads", [(9500, 50, 768, 12),
                                            (91, 13, 40, 2),
                                            (16 * 72, 72, 768, 12),
                                            (16 * 80, 80, 768, 12)])
def test_block_kernels_match_plain(cuda, dtype, tol, rows, t, d, heads):
    """The four half-block kernels against their plain versions through
    attn_half / mlp_half (forward, dx), each launched once a call; 91 rows
    and a width of 40 fill no tile; t = 72 and 80 take two key tiles, so
    the bf16 core sums rs over both before any ds.  dx of the MLP half
    goes through gelu'(u) of a u that varies over every row and column, so
    an epilogue that read u at other coordinates than its accumulator's
    would show here."""
    x, dy, p = _block(cuda, rows, d, dtype)
    a, m = p["attn"], p["mlp"]
    aw = (p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"], a["in_b"], a["out_w"])
    mw = (p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"], m["fc_b"], m["proj_w"])
    names = ("block_attn_fwd", "block_attn_bwd", "block_mlp_fwd",
             "block_mlp_bwd")
    before = [kernels.LAUNCHES[k] for k in names]
    xa = x.clone().requires_grad_(True)
    ya = BL.attn_half(xa, *aw, a["out_b"], heads, t)
    (ga,) = torch.autograd.grad(ya, xa, dy)
    xm = x.clone().requires_grad_(True)
    ym = BL.mlp_half(xm, *mw, m["proj_b"])
    (gm,) = torch.autograd.grad(ym, xm, dy)
    assert [kernels.LAUNCHES[k] - n for k, n in zip(names, before)] == [1] * 4
    yr, lse = BL.attn_half_fwd_plain(x, *aw, a["out_b"], heads, t)
    _, lse_k = BL.attn_half_fwd_kernel(x, *aw, a["out_b"], heads, t)
    assert ya.dtype == dtype and ga.dtype == dtype
    assert _rel(ya, yr) <= tol and _rel(lse_k, lse) <= tol
    assert _rel(ga, BL.attn_half_bwd_plain(x, dy, lse_k, *aw, heads, t)) <= tol
    assert _rel(ym, BL.mlp_half_fwd_plain(x, *mw, m["proj_b"])) <= tol
    assert _rel(gm, BL.mlp_half_bwd_plain(x, dy, *mw)) <= tol


def test_block_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, dy, p = _block(cuda, 30, 32, torch.float32)
    a, m = p["attn"], p["mlp"]
    aw = (p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"], a["in_b"], a["out_w"],
          a["out_b"])
    mw = (p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"], m["fc_b"], m["proj_w"],
          m["proj_b"])
    with pytest.raises(TypeError):
        BL.attn_half(x.half(), *aw, 2, 10)
    with pytest.raises(TypeError):
        BL.mlp_half(x.double(), *mw)
    with pytest.raises(ValueError):      # rows not a multiple of t
        BL.attn_half(x, *aw, 2, 7)
    with pytest.raises(ValueError):      # width not split by the heads
        BL.attn_half(x, *aw, 3, 10)
    with pytest.raises(ValueError):      # width not a multiple of 8
        BL.mlp_half_fwd_kernel(torch.zeros((30, 36), device="cuda"), *mw)
    xw = torch.zeros((30, 72), dtype=torch.bfloat16, device="cuda")
    ww = [torch.zeros(shape, device="cuda") for shape in
          ((72,), (72,), (72, 216), (216,), (72, 72), (72,))]
    with pytest.raises(ValueError):      # a bf16 head wider than 64
        BL.attn_half_fwd_kernel(xw, *ww, 1, 10)
    with pytest.raises(ValueError):      # a width the product does not take
        BL.product_kernel(xw, ww[4].bfloat16(), "bias", ww[-1].bfloat16(),
                          width=64)


def _block_fn(cuda, rows, t, d, heads, forward=False):
    """Closures of the two bf16 backward entry points (or forward ones)
    on one input."""
    x, dy, p = _block(cuda, rows, d, torch.bfloat16)
    a, m = p["attn"], p["mlp"]
    aw = (p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"], a["in_b"], a["out_w"])
    mw = (p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"], m["fc_b"], m["proj_w"])
    if forward:
        return (lambda: BL.attn_half_fwd_kernel(x, *aw, a["out_b"], heads, t),
                lambda: BL.mlp_half_fwd_kernel(x, *mw, m["proj_b"]))
    _, lse = BL.attn_half_fwd_kernel(x, *aw, a["out_b"], heads, t)
    return (lambda: BL.attn_half_bwd_kernel(x, dy, lse, *aw, heads, t),
            lambda: BL.mlp_half_bwd_kernel(x, dy, *mw))


@pytest.mark.parametrize("rows,t,d,heads", [(9500, 50, 768, 12),
                                            (16 * 80, 80, 768, 12)])
def test_bf16_block_backward_is_deterministic(cuda, rows, t, d, heads):
    """Two launches of each bf16 backward entry point give the same bits:
    the wgmma products have no split-K and no atomics, and the core sums
    every row in a fixed order."""
    for fn in _block_fn(cuda, rows, t, d, heads):
        assert torch.equal(fn(), fn())


@pytest.mark.parametrize("rows,t,d,heads", [(9500, 50, 768, 12),
                                            (16 * 80, 80, 768, 12)])
def test_bf16_block_forward_is_deterministic(cuda, rows, t, d, heads):
    """Two launches of each bf16 forward entry point give the same bits,
    y and lse: no split-K, no atomics, the row sums in a fixed order."""
    for fn in _block_fn(cuda, rows, t, d, heads, forward=True):
        first, again = fn(), fn()
        if isinstance(first, tuple):
            assert all(torch.equal(u, v) for u, v in zip(first, again))
        else:
            assert torch.equal(first, again)


def _product_case(cuda, kind, m, k, n):
    """a [m, k], w ([k, n] or, for the `@ w^T` kinds, [n, k]), bias [n]
    and aux [m, n] (u or the residual) where the kind takes them, bf16."""
    def r(*shape, std=1.0):
        return (torch.randn(shape, generator=cuda, device="cuda")
                * std).bfloat16()
    need_bias, need_aux = BL._NEEDS[kind]
    shape = (n, k) if kind in BL._W_T else (k, n)
    return (r(m, k), r(*shape, std=k ** -0.5), r(n) if need_bias else None,
            r(m, n) if need_aux else None)


@pytest.mark.parametrize("kind", ["bias", "store", "store_f32", "gelu_back"])
@pytest.mark.parametrize("m,k,n", [(9500, 768, 2304), (91, 40, 160)])
def test_block_backward_products_match_plain(cuda, kind, m, k, n):
    """Each epilogue of the wgmma product alone against its plain version:
    2^-6 relative in bf16 (one rounding each side, a float32 sum in
    another order), 1e-5 for the float32 store.  `gelu_back` reads u at
    the accumulator's coordinates; u varies everywhere, so a wrong map of
    wgmma's accumulator layout fails here.  91 x 160 fills no tile."""
    a, w, bias, aux = _product_case(cuda, kind, m, k, n)
    before = kernels.LAUNCHES["block_product"]
    got = BL.product_kernel(a, w, kind, bias, aux)
    assert kernels.LAUNCHES["block_product"] == before + 1
    ref = BL.product_plain(a, w, kind, bias, aux)
    assert got.dtype == ref.dtype and got.shape == (m, n)
    assert _rel(got, ref) <= (1e-5 if kind == "store_f32" else 2 ** -6)


@pytest.mark.parametrize("width", [256, 128])
@pytest.mark.parametrize("launch", ["qkv", "out", "fc", "proj"])
@pytest.mark.parametrize("rows,d", [(9500, 768), (91, 40), (16 * 80, 768)])
def test_block_forward_products_match_plain(cuda, width, launch, rows, d):
    """The forward chains' four products alone, at both tile widths, at
    their shapes (qkv h [R, D] in_w [D, 3D] + in_b; out-proj x + o out_w
    [D, D] + out_b; fc quick_gelu(h fc_w [D, 4D] + fc_b); proj x + a p_w
    [4D, D] + p_b) against their plain versions, 2^-6 relative.  The
    residual x varies everywhere, so an epilogue that read it at other
    coordinates than its accumulator's fails here; D = 40 makes N = 40,
    less than one 64-column box of w."""
    kind, k, n = {"qkv": ("bias", d, 3 * d), "out": ("bias_residual", d, d),
                  "fc": ("bias_gelu", d, 4 * d),
                  "proj": ("bias_residual", 4 * d, d)}[launch]
    a, w, bias, aux = _product_case(cuda, kind, rows, k, n)
    before = kernels.LAUNCHES["block_product"]
    got = BL.product_kernel(a, w, kind, bias, aux, width)
    assert kernels.LAUNCHES["block_product"] == before + 1
    ref = BL.product_plain(a, w, kind, bias, aux)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
    assert _rel(got, ref) <= 2 ** -6


@pytest.mark.parametrize("rows,t,d,heads", [(9500, 50, 768, 12),
                                            (91, 13, 40, 2),
                                            (16 * 72, 72, 768, 12),
                                            (16 * 80, 80, 768, 12)])
def test_block_tensor_core_attention_forward_matches_plain(cuda, rows, t, d,
                                                           heads):
    """The bf16 core forward alone against `_attn_core_fwd`: o at 2^-6
    relative; lse within 1e-5 of each entry (1e-5 relative on the row
    sums), since both sum the float32 e (summing the bf16-rounded e
    instead drifts ~1e-4, and a row sum that counted a zero-filled key
    past t would gain 1 a key).  One and two 64-key tiles (the second
    rescaling the first's sum and o), and a head 20 wide, padded to 64."""
    x, _, p = _block(cuda, rows, d, torch.bfloat16)
    a = p["attn"]
    h = BL._ln(x, p["ln_1"]["g"], p["ln_1"]["b"])[0]
    qkv = BL._mm_bias(h, a["in_w"], a["in_b"])
    before = kernels.LAUNCHES["block_core_fwd"]
    o, lse = BL.core_fwd_kernel(qkv, heads, t)
    assert kernels.LAUNCHES["block_core_fwd"] == before + 1
    o_r, lse_r = BL._attn_core_fwd(qkv, heads, t)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert bool(torch.isfinite(o).all())
    assert _rel(o, o_r) <= 2 ** -6
    assert (lse - lse_r).abs().max().item() <= 1e-5


@pytest.mark.parametrize("rows,t,d,heads", [(9500, 50, 768, 12),
                                            (91, 13, 40, 2),
                                            (16 * 80, 80, 768, 12),
                                            (4 * 129, 129, 768, 12)])
def test_block_tensor_core_attention_backward_matches_plain(cuda, rows, t, d,
                                                            heads):
    """The bf16 core alone (the dq pass, then dk/dv from its rs) against
    `_attn_core_bwd` at 2^-6 relative: one, two and three 64-key tiles,
    and a head 20 wide, padded to 64."""
    x, dy, p = _block(cuda, rows, d, torch.bfloat16)
    a = p["attn"]
    h = BL._ln(x, p["ln_1"]["g"], p["ln_1"]["b"])[0]
    qkv = BL._mm_bias(h, a["in_w"], a["in_b"])
    _, lse = BL._attn_core_fwd(qkv, heads, t)
    got = BL.core_bwd_kernel(qkv, dy, lse, heads, t)
    ref = BL._attn_core_bwd(qkv, dy, lse, heads, t)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= 2 ** -6


def test_block_halves_capture_into_a_graph(cuda):
    """attn_half and mlp_half, forward and autograd backward, in bf16 at
    ViT-B/32's shape, captured into one CUDA graph: the per-call tensor
    maps and scratch need no host sync, and the replay equals the eager
    call bit for bit."""
    x, dy, p = _block(cuda, 9500, 768, torch.bfloat16)
    a, m = p["attn"], p["mlp"]

    def step():
        xr = x.detach().requires_grad_(True)
        y = BL.attn_half(xr, p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"],
                         a["in_b"], a["out_w"], a["out_b"], 12, 50)
        y = BL.mlp_half(y, p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"],
                        m["fc_b"], m["proj_w"], m["proj_b"])
        (gx,) = torch.autograd.grad(y, xr, dy)
        return y.detach(), gx
    (y0, g0), (y1, g1) = _captured(step)
    assert torch.equal(y0, y1) and torch.equal(g0, g1)


def _hot(p, d=768, heads=12):
    """The block `p` with every head's scores lifted by ~80: the k
    projection's first column of each head is the constant 16 (zero weight,
    bias 16, exact in bf16) and the q projection's bias there 40, so each
    row's scores gain 2 q_0 = 80 +- 2, the same for all its keys.  The
    exact softmax does not move; exp(min(s, 60)) would flatten every row."""
    a = dict(p["attn"])
    in_w, in_b = a["in_w"].clone(), a["in_b"].clone()
    for h in range(heads):
        in_w[:, d + 64 * h] = 0
        in_b[d + 64 * h] = 16
        in_b[64 * h] = 40
    a["in_w"], a["in_b"] = in_w, in_b
    return dict(p, attn=a)


@pytest.mark.parametrize("hot", [False, True])
def test_vit_b32_blocks_take_the_fused_route_and_match_the_unfused(
        cuda, monkeypatch, hot):
    """ViT-B/32's bf16 blocks on the card take the fused halves by default
    (no switch set; `kernels.LAUNCHES` counts one of each entry point a
    block and no attention kernel), and their forward and input gradient
    match the unfused route (`resblock_flat`: cuBLAS products and
    csrc/attention.cu) at the block tolerance, 2^-6 relative.  `hot`: with
    every score past 60, so only an exact softmax on both routes agrees."""
    from aphantasia_torch.models.clip import model as M
    monkeypatch.delenv("APHANTASIA_FUSED_BLOCK", raising=False)
    rows, t, d, heads = 190 * 50, 50, 768, 12
    x, dy, p = _block(cuda, rows, d, torch.bfloat16)
    if hot:
        p = _hot(p)
        h = BL._ln(x, p["ln_1"]["g"], p["ln_1"]["b"])[0]
        q, k, _ = BL._split(BL._mm_bias(h, p["attn"]["in_w"],
                                        p["attn"]["in_b"]), heads, t)
        assert BL._scores(q, k, 64).amax(-1).min().item() > 60.0
    assert M.fused_blocks(x, [p], t)
    outs = []
    for fn in (lambda v: M.transformer_flat(v, [p], heads, t),
               lambda v: M.resblock_flat(v, p, heads, t)):
        kernels.reset_launches()
        xr = x.clone().requires_grad_(True)
        y = fn(xr)
        (g,) = torch.autograd.grad(y, xr, dy)
        outs.append((y, g, {k: v for k, v in kernels.LAUNCHES.items() if v}))
    (y_f, g_f, n_f), (y_u, g_u, n_u) = outs
    assert n_f == {"block_attn_fwd": 1, "block_attn_bwd": 1,
                   "block_mlp_fwd": 1, "block_mlp_bwd": 1}
    assert n_u == {"attn_fwd": 1, "attn_bwd": 1}
    assert bool(torch.isfinite(y_f).all()) and bool(torch.isfinite(g_f).all())
    assert _rel(y_f, y_u) <= 2 ** -6 and _rel(g_f, g_u) <= 2 ** -6


def test_vit_b32_tower_route_by_default(cuda, monkeypatch):
    """The whole ViT-B/32 image tower, bf16, forward and image gradient: 12
    of each fused entry point and no attention kernel by default; in
    float32 (the card-against-CPU checks) and under a closed geometry gate
    (ViT-B/16's t = 197) the blocks stay unfused."""
    from aphantasia_torch.models.clip.model import (CLIP_CONFIGS, clip_init,
                                                    encode_image)
    monkeypatch.delenv("APHANTASIA_FUSED_BLOCK", raising=False)
    for name, dtype, want in (
            ("ViT-B/32", torch.bfloat16,
             {k: 12 for k in ("block_attn_fwd", "block_attn_bwd",
                              "block_mlp_fwd", "block_mlp_bwd")}),
            ("ViT-B/32", torch.float32, {"attn_fwd": 12, "attn_bwd": 12}),
            ("ViT-B/16", torch.bfloat16, {"attn_fwd": 12, "attn_bwd": 12})):
        cfg = CLIP_CONFIGS[name]
        vis = {"visual": cast_weights(clip_init(cuda, cfg)["visual"], dtype)}
        x = torch.randn((8, 3, 224, 224), generator=cuda, device="cuda",
                        requires_grad=True)
        kernels.reset_launches()
        emb = encode_image(vis, cfg, x, dtype)
        (gx,) = torch.autograd.grad(emb.float().square().sum(), x)
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert got == want, (name, dtype, got)
        assert bool(torch.isfinite(gx).all()) and gx.abs().max().item() > 0


@pytest.mark.parametrize("registered", [True, False])
def test_frame_writer_admits_a_card_frame_without_waiting(
        cuda, tmp_path, monkeypatch, registered):
    """A frame on the card is admitted into a slot registered as pinned
    memory by a non-blocking copy and an event: with ~1 s of work queued
    ahead of it, its "writer.admit" span stays under 1 ms, the work is
    still running when the admission returns, and the file holds the
    frame's bytes once the writer closes.  Where registration fails (here
    made to), the copy lands in a pinned staging buffer instead, just as
    fast, and reaches the slot once its event has completed."""
    import io
    from PIL import Image
    from aphantasia_torch.io.media import AsyncFrameWriter
    from aphantasia_torch.profiling import collect
    if not registered:
        rt = torch.cuda.cudart()

        class Refusing:
            cudaError = rt.cudaError

            def cudaHostRegister(self, *args):
                return "refused"        # anything but cudaError.success

            def __getattr__(self, name):
                return getattr(rt, name)
        monkeypatch.setattr(torch.cuda, "cudart", lambda: Refusing())
    frame = torch.randint(0, 256, (720, 1280, 3), generator=cuda,
                          device="cuda").to(torch.uint8)
    with AsyncFrameWriter(encoders=2) as w:
        w.save_batch([str(tmp_path / "warm.jpg")], frame[None])
        w.flush()                   # the slot exists, registered or not
        slot = w._slots[0]
        if registered:
            assert slot.pinned >= frame.numel() and slot.staging is None
        else:
            assert slot.pinned == 0 and slot.staging.is_pinned()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)
        with collect() as got:
            w.save_batch([str(tmp_path / "a.jpg")], frame[None])
        busy = not torch.cuda.current_stream().query()
    (admit,) = [r for r in got if r.name == "writer.admit"]
    assert busy and admit.seconds < 1e-3, admit.seconds
    buf = io.BytesIO()
    Image.fromarray(frame.cpu().numpy()).save(buf, format="JPEG")
    assert (tmp_path / "a.jpg").read_bytes() == buf.getvalue()


# ------------------------------------------------------------ the step loop

def _chip_smoke():
    """The repository's chip_smoke.py, whose `loop` phase this file's loop
    tests share."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("path", range(10))
def test_replayed_loop_equals_the_eager_steps(cuda, path):
    """chip_smoke.py's `loop` phase on one of its ten paths at full width
    (1280x720, 200 samples before the budget), 4 frame groups (opt_step 2
    on `--pallas` and on `--dualmod 3`, whose groups take three tower
    patterns), 2 a dispatch: the replayed loop against two eager runs
    from the same draws, params, optimizer state, prev_enc, losses and
    frames bit for bit (or within twice the eager runs' own spread), the
    launches counted per replay, the dispatches that only replay under
    sync debug mode "error"."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cs.phase_loop(steps=4, nf=2, paths=[cs.LOOP_PATHS[path]])
    except cs.SmokeFailure as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("path", range(3))
def test_illustrip_frames_replay_equal_eager(cuda, path):
    """chip_smoke.py's illustrip loop on one of its three paths (RGB, FFT
    --smooth, FFT --depth 1) at full width, 4 frames of 2 steps: the frame
    step (its first frame eager and captured, the others and the DA-V2
    forward replayed) against two eager runs of its pieces, bit for bit
    (or within twice the eager runs' spread)."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cs.phase_loop_illustrip(frames=4, paths=[cs.TRIP_LOOP_PATHS[path]])
    except cs.SmokeFailure as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("path", range(2))
def test_coord_and_vqgan_loops_replay_equal_eager(cuda, path):
    """chip_smoke.py's loop on cppn (`--fstep 2`, the per-group params
    snapshots) or clip_vqgan (the f16 decoder at 640x480) at full width,
    8 steps, 2 groups a dispatch: the replayed frame loop against two
    eager runs, params, optimizer state, prev_enc, losses, frames and
    snapshots bit for bit (or within twice the eager runs' spread)."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cs.phase_loop_coord(steps=8, nf=2, paths=[cs.COORD_LOOP_PATHS[path]])
    except cs.SmokeFailure as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("name,h,w", [("imagenet_f16_16384", 480, 640),
                                      ("gumbel_f8_8192", 512, 640)])
def test_vqgan_bf16_decode_within_the_jax_bound(cuda, name, h, w):
    """The bf16 VQGAN decode (the card's "auto") against the float32 one
    at a CLI's full size, random weights: mean |diff| / std < 0.05 and
    correlation > 0.995, the JAX package's bound (tests/test_vqgan.py);
    both dtypes' decode and latent gradient replay from a CUDA graph."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        r = cs.check_vqgan_decode(name, h, w)
    except cs.SmokeFailure as e:
        pytest.fail(str(e))
    assert r["err"] < 0.05 and r["corr"] > 0.995
    assert all(r[k] > 0 for k in ("fwd_bf16", "step_bf16", "fwd_f32",
                                  "step_f32"))


def test_frame_writer_pulls_a_chunk_from_the_card(cuda, tmp_path):
    """save_batch of a uint8 chunk on the card: one non-blocking copy into
    pinned memory, waited on by the encoders; the PNGs hold its bytes."""
    from PIL import Image
    from aphantasia_torch.io.media import AsyncFrameWriter
    frames = torch.randint(0, 256, (3, 16, 24, 3), generator=cuda,
                           device="cuda").to(torch.uint8)
    paths = [str(tmp_path / f"{i}.png") for i in range(3)]
    with AsyncFrameWriter(encoders=2) as w:
        w.save_batch(paths, frames)
    for i, path in enumerate(paths):
        with Image.open(path) as im:
            assert (np.asarray(im) == frames[i].cpu().numpy()).all()


def test_loop_capture_failure_raises(cuda):
    """A step the graph cannot capture (here a host sync) raises from the
    first group's capture after its eager run: no eager fallback."""
    from aphantasia_torch.step import LoopBuffers, StepGroup

    def syncing_step(p, st, prev, clip, aest, lpips, prompts, draws, si):
        p.add_(float(p.sum()))
        return p, st, prev, p.sum()
    p = torch.ones(8, device="cuda")
    bufs = LoopBuffers(1)
    group = StepGroup((syncing_step,), (0,), False, bufs)
    bufs.bind(p, None, torch.zeros(8, device="cuda"), (({}, None, None, ()),),
              [None])
    with pytest.raises(RuntimeError):
        group.run(0)
    assert group.graph is None


def test_lpips_term_replays_equal_eager(cuda):
    """The `--sync` term at its full-width shapes (the 720x1280 frame
    resized to 360x640 against a 360x640 target, VGG16 on cuDNN with
    deterministic algorithms, float32), forward and input gradient,
    captured into a CUDA graph: the replay equals the eager call bit for
    bit, and two eager calls agree."""
    from aphantasia_torch.models.lpips import lpips_apply, lpips_init
    from aphantasia_torch.ops.resize import resize_bicubic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    params = lpips_init(cuda)
    img = torch.rand((1, 3, 720, 1280), generator=cuda, device="cuda")
    target = torch.rand((1, 3, 360, 640), generator=cuda, device="cuda")

    def term():
        x = img.detach().requires_grad_(True)
        d = lpips_apply(params, resize_bicubic(x, (360, 640)), target)
        (g,) = torch.autograd.grad(d.mean(), x)
        return d.detach(), g
    (d0, g0), (d1, g1) = _captured(term)
    d2, g2 = term()
    assert torch.isfinite(d0).all() and torch.isfinite(g0).all()
    assert torch.equal(d0, d1) and torch.equal(g0, g1)
    assert torch.equal(d0, d2) and torch.equal(g0, g2)


def test_dwt_decode_replays_equal_eager(cuda):
    """The `--dwt` decode at full width (a coif2 pyramid of 9 levels for
    720x1280) and its gradient, captured: the replay equals the eager call
    bit for bit."""
    from aphantasia_torch.params.dwt import DWTParameterizer
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    par = DWTParameterizer((720, 1280), "coif2", 0.3, 1.8)
    pyr = par.init(cuda)
    co = torch.rand((1, 3, 720, 1280), generator=cuda, device="cuda")

    def decode():
        xs = [x.detach().requires_grad_(True) for x in pyr]
        img = par.image(xs, contrast=1.1)
        return (img.detach(),) + torch.autograd.grad(img, xs, co)
    eager, replayed = _captured(decode)
    assert eager[0].shape == (1, 3, 720, 1280)
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))


def test_mesh_wider_than_the_host_raises(cuda, tmp_path):
    """--mesh asks one GPU per rank on this host: a mesh of more ranks
    than the host has GPUs raises before any rank starts."""
    from aphantasia_torch.cli import clip_fft
    n = torch.cuda.device_count() + 1
    for spec in (str(n), f"{n}x1"):
        with pytest.raises(SystemExit, match=f"needs {n} devices"):
            clip_fft.run(clip_fft.get_args(["-t", "x", "--out_dir",
                                            str(tmp_path), "--mesh", spec]))


def _three_kernels(mark=lambda x, name: x):
    """A bf16 product, an in-place scale and an in-place sum, each one
    kernel of about a millisecond (so an event node's few microseconds
    stay under 1% of it), each behind a mark of its name."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    a = torch.randn((8192, 8192), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    c = torch.empty_like(a)
    x = torch.rand(2 ** 28, generator=gen, device="cuda")
    y = torch.rand(2 ** 28, generator=gen, device="cuda")

    def fn():
        torch.mm(mark(a, "mm"), a, out=c)
        mark(x, "mul").mul_(1.0001)
        mark(y, "add").add_(x)
        mark(y, "end")
    return fn, (c, x, y)


def _counted(fn):
    """fn() on a side stream, then captured into a CountedGraph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = kernels.CountedGraph()
    with graph.capture():
        fn()
    return graph


def test_counted_graph_counts_its_kernel_nodes_and_times_its_marks(cuda):
    """A graph of three known kernels: three kernel nodes (a mark is an
    event node, not a kernel), and the marks' intervals of a replay
    within 5% of the profiler's time of the kernel each holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aphantasia_torch.profiling import mark
    fn, _ = _three_kernels(mark)
    graph = _counted(fn)
    assert graph.nodes["kernel"] == 3
    assert graph.nodes["event_record"] == 4
    assert [n for n, _ in graph.marks] == ["mm", "mul", "add", "end"]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    graph.replay()              # the marks of a replay the profiler missed
    torch.cuda.synchronize()
    ms = graph.layer_ms()
    kern = [e.duration_ns() / 1e6
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.name().startswith("Memset")]
    assert len(kern) == 3
    pairs = [(ms[name], k) for name, k in zip(("mm", "mul", "add"), kern)]
    assert all(abs(m - k) <= 0.05 * k for m, k in pairs), pairs


def test_keep_graph_replay_equals_the_eager_calls(cuda):
    """A CountedGraph (captured with keep_graph, its nodes walked, then
    instantiated) replays what the eager calls compute, bit for bit."""
    fn, outs = _three_kernels()
    starts = [t.clone() for t in outs]
    fn()
    eager = [t.clone() for t in outs]
    for t, s in zip(outs, starts):
        t.copy_(s)
    graph = _counted(fn)
    for t, s in zip(outs, starts):
        t.copy_(s)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, eager))


def test_step_marks_cover_the_replayed_group(cuda):
    """A captured clip_fft group (1280x720 FFT, ViT-B/32 in bf16 on 64
    cutouts, a step and the render): its marks name the decode, cut,
    tower, loss, optimizer and render, and their intervals sum to within
    3% of the replay's device time."""
    from aphantasia_torch.models.clip import model as tm
    from aphantasia_torch.ops import optim as to
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.step import (StepSettings, build_draw_fn,
                                       build_train_loop_frames)
    cfg = tm.CLIP_CONFIGS["ViT-B/32"]
    par = FFTParameterizer((720, 1280), 1.5, 1.8)
    sampler = CutoutSampler((720, 1280), 64, 224, "uniform")
    settings = StepSettings(transform="fast", clip_dtype=torch.bfloat16)
    opt = to.build_optimizer("adam", 0.05)
    vis = {"visual": cast_weights(tm.clip_init(cuda, cfg)["visual"],
                                  torch.bfloat16)}
    prompts = ((torch.randn((1, 512), generator=cuda, device="cuda"),
                torch.ones(1, device="cuda"),
                torch.full((), -1.0, device="cuda")),)
    params = par.init(cuda)
    loop = build_train_loop_frames(par, sampler, cfg, settings, opt, 1, 2)
    draw = build_draw_fn(sampler, settings, tuple(params.shape))
    state = (params, opt.init(params), torch.zeros((64, 512), device="cuda"))
    for c in range(2):
        state = loop(*state, vis, None, None, prompts,
                     lambda g: draw(cuda), 2 * c)[:3]
    (group,) = loop.groups.values()
    graph = group.graph
    assert graph.nodes["kernel"] > 100
    names = [n for n, _ in graph.marks]
    assert names == ["decode", "cut", "tower", "loss", "loss.bwd",
                     "tower.bwd", "cut.bwd", "decode.bwd", "render", "group"]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    total = start.elapsed_time(stop)
    ms = graph.layer_ms()
    assert set(ms) == {"decode", "cut", "tower", "loss", "step", "render"}
    assert 0.97 * total <= sum(ms.values()) <= total, (ms, total)


def test_unfused_tower_graph_times_its_attention_apart(cuda, monkeypatch):
    """A captured step group (`build_train_loop_frames`, as the CLIs
    capture it) whose tower runs unfused (ViT-B/16 in bf16, t = 197, 4
    cutouts of a 256x256 FFT frame) holds an "attn" and a "tower" mark
    around each layer's attention core and again in its backward (4 event
    nodes a layer beside the step's 10), and `layer_ms()` gives "attn"
    (the cores, forward and backward) apart from the rest of the tower."""
    from aphantasia_torch.models.clip import model as tm
    from aphantasia_torch.ops import optim as to
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.step import (StepSettings, build_draw_fn,
                                       build_train_loop_frames)
    monkeypatch.delenv("APHANTASIA_FUSED_BLOCK", raising=False)
    cfg = tm.CLIP_CONFIGS["ViT-B/16"]
    par = FFTParameterizer((256, 256), 1.5, 1.8)
    sampler = CutoutSampler((256, 256), 4, 224, "uniform")
    settings = StepSettings(transform="fast", clip_dtype=torch.bfloat16)
    opt = to.build_optimizer("adam", 0.05)
    vis = {"visual": cast_weights(tm.clip_init(cuda, cfg)["visual"],
                                  torch.bfloat16)}
    prompts = ((torch.randn((1, 512), generator=cuda, device="cuda"),
                torch.ones(1, device="cuda"),
                torch.full((), -1.0, device="cuda")),)
    params = par.init(cuda)
    loop = build_train_loop_frames(par, sampler, cfg, settings, opt, 1, 2)
    draw = build_draw_fn(sampler, settings, tuple(params.shape))
    state = (params, opt.init(params), torch.zeros((4, 512), device="cuda"))
    for c in range(2):
        state = loop(*state, vis, None, None, prompts,
                     lambda g: draw(cuda), 2 * c)[:3]
    (group,) = loop.groups.values()
    graph = group.graph
    names = [n for n, _ in graph.marks]
    assert names[:5] == ["decode", "cut", "tower", "attn", "tower"]
    assert names.count("attn") == names.count("attn.bwd") == 12
    assert graph.nodes["event_record"] == 10 + 4 * 12
    graph.replay()
    torch.cuda.synchronize()
    ms = graph.layer_ms()
    assert set(ms) == {"decode", "cut", "tower", "attn", "loss", "step",
                       "render"}
    assert ms["attn"] > 0 < ms["tower"]


def test_fused_tower_graph_keeps_its_node_count(cuda, monkeypatch):
    """ViT-B/32's fused bf16 blocks hold no attention marks: a captured
    tower (forward and image gradient, 4 images) has no event node and the
    same nodes as with the marks turned off."""
    from aphantasia_torch.models.clip import model as tm
    monkeypatch.delenv("APHANTASIA_FUSED_BLOCK", raising=False)
    cfg = tm.CLIP_CONFIGS["ViT-B/32"]
    vis = {"visual": cast_weights(tm.clip_init(cuda, cfg)["visual"],
                                  torch.bfloat16)}
    x = torch.randn((4, 3, 224, 224), generator=cuda, device="cuda")
    co = torch.randn((4, cfg.embed_dim), generator=cuda, device="cuda")

    def fn():
        xx = x.detach().requires_grad_(True)
        emb = tm.encode_image(vis, cfg, xx, torch.bfloat16).float()
        return torch.autograd.grad(emb, xx, co)[0]
    counts = []
    for off in (False, True):
        if off:
            monkeypatch.setattr(tm, "mark", lambda x, name: x)
        graph = _counted(fn)
        assert graph.marks == [] and graph.nodes["event_record"] == 0
        counts.append(dict(graph.nodes))
    assert counts[0] == counts[1] and counts[0]["kernel"] > 0
