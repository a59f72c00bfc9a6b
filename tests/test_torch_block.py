"""The port's fused half blocks (aphantasia_torch/ops/block.py) against the
JAX package's pallas_block (interpret mode on the CPU), and the port's
tower under APHANTASIA_FUSED_BLOCK=1 against the JAX tower.

Sizes are the JAX test's (tests/test_pallas_block.py): t = 10 tokens,
D = 32, 2 heads, JAX row blocks of BB = 4 samples, `_block_init` weights
converted by convert.py; inputs are numpy draws from seeds.  8 samples
fill two JAX blocks; 3 samples leave a ragged one that JAX pads.

Tolerances.  float32: the JAX test's, values within 2e-5 and dx within
rtol 2e-4, atol 2e-5.  bf16: within one bf16 step of the largest entry
(2^-7 relative), and at most 2% of the entries may differ at all.  Both
sides round at the same points, so only a float32 sum taken in another
order can flip a rounding (on the CPU they agree bit for bit at these
sizes); a plain backward that rounded dh or da to bf16 changes 16-40% of
the dx entries by one step.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.ops import pallas_attn as jattn
from aphantasia_tpu.ops import pallas_block as jb
from aphantasia_torch.convert import clip_params_from_numpy
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import block as tb

from _torch_parity import tree_np

T, BB, D, NH = 10, 4, 32, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def blocks():
    """Two blocks' params: JAX (float32) and the port's (float32)."""
    jps = [jm._block_init(jax.random.PRNGKey(k), D) for k in (0, 9)]
    return jps, [clip_params_from_numpy(tree_np(p)) for p in jps]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _inputs(rows, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, D).astype(np.float32),
            rs.randn(rows, D).astype(np.float32))


def _jax_fn(which, p, t=T, bb=BB):
    a, m = p["attn"], p["mlp"]
    if which == "attn":
        return lambda v: jb.attn_half(v, p["ln_1"]["g"], p["ln_1"]["b"],
                                      a["in_w"], a["in_b"], a["out_w"],
                                      a["out_b"], NH, t, bb)
    if which == "mlp":
        return lambda v: jb.mlp_half(v, p["ln_2"]["g"], p["ln_2"]["b"],
                                     m["fc_w"], m["fc_b"], m["proj_w"],
                                     m["proj_b"], min(bb * t, 128))
    return lambda v: jb.resblock_flat_fused(v, p, NH, t, bb)


def _torch_fn(which, p, t=T):
    a, m = p["attn"], p["mlp"]
    if which == "attn":
        return lambda v: tb.attn_half(v, p["ln_1"]["g"], p["ln_1"]["b"],
                                      a["in_w"], a["in_b"], a["out_w"],
                                      a["out_b"], NH, t)
    if which == "mlp":
        return lambda v: tb.mlp_half(v, p["ln_2"]["g"], p["ln_2"]["b"],
                                     m["fc_w"], m["fc_b"], m["proj_w"],
                                     m["proj_b"])
    return lambda v: tb.resblock_flat_fused(v, p, NH, t)


def _assert_bf16_close(got, want):
    got, want = _np(got), _np(want)
    err = np.abs(got - want)
    assert err.max() <= 2.0 ** -7 * np.abs(want).max(), err.max()
    assert (err > 0).mean() <= 0.02, (err > 0).mean()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("samples", [8, 3])
@pytest.mark.parametrize("which", ["attn", "mlp", "block"])
def test_fused_halves_match_jax(blocks, which, samples, dt):
    """Forward and dx of attn_half, mlp_half and resblock_flat_fused
    (plain versions on the CPU) against the JAX kernels in interpret
    mode."""
    jd, td = DTYPES[dt]
    jps, tps = blocks
    tp = tm.cast_weights(tps[0], td)
    x, co = _inputs(samples * T)
    y_j, vjp = jax.vjp(_jax_fn(which, jps[0]), jnp.asarray(x).astype(jd))
    (g_j,) = vjp(jnp.asarray(co).astype(jd))
    xt = torch.tensor(x).to(td).requires_grad_(True)
    y_t = _torch_fn(which, tp)(xt)
    (g_t,) = torch.autograd.grad(y_t, xt, torch.tensor(co).to(td))
    assert y_t.dtype == td and g_t.dtype == td
    assert y_t.shape == xt.shape
    if dt == "float32":
        np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=2e-4, atol=2e-5)
    else:
        _assert_bf16_close(y_t, y_j)
        _assert_bf16_close(g_t, g_j)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("which,t", [("attn", 72), ("attn", 80),
                                     ("block", 80)])
def test_fused_halves_match_jax_across_key_tiles(blocks, monkeypatch, which,
                                                 t, dt):
    """As above at t = 72 and 80, which the gate opens and which the
    card's bf16 core takes in two 64-key tiles: the plain version that the
    card holds that core against is itself held against the JAX kernels
    (row blocks of `flat_geometry`'s samples, 3 samples: one ragged
    block), at the same tolerances."""
    monkeypatch.delenv("APHANTASIA_ATTN_ROWS", raising=False)
    jd, td = DTYPES[dt]
    bb = jattn.flat_geometry(t, jd)
    jps, tps = blocks
    tp = tm.cast_weights(tps[0], td)
    x, co = _inputs(3 * t, seed=11)
    y_j, vjp = jax.vjp(_jax_fn(which, jps[0], t, bb),
                       jnp.asarray(x).astype(jd))
    (g_j,) = vjp(jnp.asarray(co).astype(jd))
    xt = torch.tensor(x).to(td).requires_grad_(True)
    y_t = _torch_fn(which, tp, t)(xt)
    (g_t,) = torch.autograd.grad(y_t, xt, torch.tensor(co).to(td))
    assert y_t.dtype == td and g_t.dtype == td
    if dt == "float32":
        np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=2e-4, atol=2e-5)
    else:
        _assert_bf16_close(y_t, y_j)
        _assert_bf16_close(g_t, g_j)


@pytest.mark.parametrize("which", ["attn", "mlp"])
def test_plain_backward_is_the_vjp_of_the_plain_forward(blocks, which):
    """The closed-form plain backward equals autograd's transpose of the
    plain forward, float32, within 1e-5 of the largest entry."""
    p = blocks[1][1]
    x, co = _inputs(6 * T, seed=5)
    xt = torch.tensor(x, requires_grad=True)
    cot = torch.tensor(co)
    if which == "attn":
        a = p["attn"]
        ws = (p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"], a["in_b"],
              a["out_w"])
        y, inv = tb.attn_half_fwd_plain(xt, *ws, a["out_b"], NH, T)
        got = tb.attn_half_bwd_plain(xt.detach(), cot, inv.detach(), *ws,
                                     NH, T)
    else:
        m = p["mlp"]
        ws = (p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"], m["fc_b"],
              m["proj_w"])
        y = tb.mlp_half_fwd_plain(xt, *ws, m["proj_b"])
        got = tb.mlp_half_bwd_plain(xt.detach(), cot, *ws)
    (want,) = torch.autograd.grad(y, xt, cot)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [17, 50, 72, 80, 197, 257])
def test_flat_geometry_matches_jax(monkeypatch, t, dt):
    """The gate of the fused path: open for t = 50 (ViT-B/32), the tiny
    test towers' 17 and the two-key-tile 72 and 80, shut for ViT-B/16's
    197 and ViT-L/14's 257."""
    monkeypatch.delenv("APHANTASIA_ATTN_ROWS", raising=False)
    jd, td = DTYPES[dt]
    want = jattn.flat_geometry(t, jd)
    assert tb.flat_geometry(t, td) == want
    assert (want is None) == (t in (197, 257))


def test_transformer_flat_under_the_switch_matches_jax(blocks, monkeypatch):
    """Two blocks through transformer_flat with APHANTASIA_FUSED_BLOCK=1 on
    both sides (each reads it per call): the port runs
    block.resblock_flat_fused once a block, JAX its fused kernels in
    interpret mode.  Forward and dx at the float32 tolerances."""
    jps, tps = blocks
    calls = []
    fused = tb.resblock_flat_fused

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return fused(*a, **k)
    monkeypatch.setattr(tb, "resblock_flat_fused", counted)
    monkeypatch.setenv("APHANTASIA_FUSED_BLOCK", "1")
    x, co = _inputs(3 * T, seed=7)
    y_j, vjp = jax.vjp(lambda v: jm.transformer_flat(v, jps, NH, T),
                       jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    y_t = tm.transformer_flat(xt, tps, NH, T)
    (g_t,) = torch.autograd.grad(y_t, xt, torch.tensor(co))
    assert calls == [(3 * T, D)] * 2
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=2e-4, atol=2e-5)


def _hot_block(p, gain=6.0):
    """The block `p` with its q and k projections scaled by `gain`, so
    its attention scores pass the TPU kernel's clamp at 60."""
    a = dict(p["attn"])
    w = a["in_w"].clone()
    w[:, :2 * D] *= gain
    a["in_w"] = w
    return dict(p, attn=a)


@pytest.mark.parametrize("t", [T, 80])
def test_fused_plain_matches_resblock_flat_past_the_clamp(blocks, t):
    """Where scores pass 60 (q and k scaled up: exp(min(s, 60)) would lose
    them), the fused block's plain version still matches resblock_flat,
    whose attention subtracts the row max: both softmaxes are exact.
    float32, forward and dx within 1e-4 of their largest entry (the
    scaled scores make the backward's float32 sums 6x larger); the
    clamped softmax misses by whole units.  At t = 80 the scores span two
    of the card's 64-key tiles."""
    p = _hot_block(blocks[1][0])
    x, co = _inputs(3 * t, seed=13)
    h = tb._ln(torch.tensor(x), p["ln_1"]["g"], p["ln_1"]["b"])[0]
    qkv = tb._mm_bias(h, p["attn"]["in_w"], p["attn"]["in_b"])
    q, k, _ = tb._split(qkv, NH, t)
    assert tb._scores(q, k, D // NH).max() > 60.0
    outs = []
    for fn in (tb.resblock_flat_fused, tm.resblock_flat):
        xt = torch.tensor(x, requires_grad=True)
        y = fn(xt, p, NH, t)
        (g,) = torch.autograd.grad(y, xt, torch.tensor(co))
        outs.append((_np(y), _np(g)))
    (y_f, g_f), (y_u, g_u) = outs
    assert np.isfinite(y_f).all() and np.isfinite(g_f).all()
    for got, want in ((y_f, y_u), (g_f, g_u)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,fused", [(50, True), (197, False),
                                     (257, False)])
def test_switch_takes_the_fused_path_only_where_the_gate_opens(
        blocks, monkeypatch, t, fused, dt):
    """Under the switch ViT-B/32's t = 50 runs the fused halves; ViT-B/16's
    197 and ViT-L/14's 257 keep the unfused blocks; without the switch no
    block is fused."""
    calls = []
    monkeypatch.setattr(tb, "resblock_flat_fused",
                        lambda *a: calls.append(1) or a[0])
    p = tm.cast_weights(blocks[1][0], dt)
    x = torch.zeros((2 * t, D), dtype=dt)
    monkeypatch.setenv("APHANTASIA_FUSED_BLOCK", "1")
    tm.transformer_flat(x, [p], NH, t)
    assert calls == ([1] if fused else [])
    monkeypatch.delenv("APHANTASIA_FUSED_BLOCK")
    tm.transformer_flat(x, [p], NH, t)
    assert len(calls) == int(fused)


CFG_KW = dict(name="tiny", embed_dim=32, image_resolution=32,
              vision_layers=2, vision_width=128, vision_patch_size=8,
              transformer_width=64, transformer_heads=2, transformer_layers=2)


def test_image_tower_under_the_block_switch_matches_jax(monkeypatch):
    """61 cutouts of 17 tokens at width 128: under APHANTASIA_FUSED_BLOCK=1
    the port's 2 vision blocks run resblock_flat_fused (plain versions on
    the CPU).  On the CPU the JAX tower keeps its unfused [B, T, D] stream
    (its flat branch needs the TPU), so it is the reference here; the
    halves are held against pallas_block above.  Forward and image
    gradient, 1e-4 relative to the largest entry."""
    jcfg, tcfg = jm.CLIPConfig(**CFG_KW), tm.CLIPConfig(**CFG_KW)
    jp = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    tp = clip_params_from_numpy(tree_np(jp))
    calls = []
    fused = tb.resblock_flat_fused

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return fused(*a, **k)
    monkeypatch.setattr(tb, "resblock_flat_fused", counted)
    monkeypatch.setenv("APHANTASIA_FUSED_BLOCK", "1")
    x = np.random.RandomState(3).randn(61, 3, 32, 32).astype(np.float32)
    co = np.random.RandomState(4).randn(61, 32).astype(np.float32)
    out_j, vjp = jax.vjp(lambda im: jm.encode_image(jp, jcfg, im),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm.encode_image(tp, tcfg, xt)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    assert calls == [(61 * 17, 128)] * 2
    for got, want in ((out_t, out_j), (g_t, g_j)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want,
                                   atol=1e-4 * np.abs(want).max())


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(blocks):
    """The checks run before any kernel is built, so they hold here; a
    tensor on neither the CPU nor a CUDA device has no path at all."""
    p = blocks[1][1]
    a, m = p["attn"], p["mlp"]
    g, b = p["ln_1"]["g"], p["ln_1"]["b"]
    aw = (g, b, a["in_w"], a["in_b"], a["out_w"], a["out_b"])
    mw = (g, b, m["fc_w"], m["fc_b"], m["proj_w"], m["proj_b"])
    x = torch.zeros((3 * T, D))
    with pytest.raises(TypeError):
        tb.attn_half_fwd_kernel(x.half(), *aw, NH, T)
    with pytest.raises(TypeError):
        tb.mlp_half_fwd_kernel(x[None], *mw)
    with pytest.raises(ValueError):          # rows not a multiple of t
        tb.attn_half_fwd_kernel(x[:25], *aw, NH, T)
    with pytest.raises(ValueError):          # width not split by the heads
        tb.attn_half_fwd_kernel(x, *aw, 3, T)
    with pytest.raises(ValueError):          # width not a multiple of 8
        tb.mlp_half_fwd_kernel(torch.zeros((30, 36)), *mw)
    with pytest.raises(ValueError):          # a weight of the wrong shape
        tb.mlp_half_bwd_kernel(x, x, g, b, m["fc_w"][:, :64], m["fc_b"],
                               m["proj_w"])
    with pytest.raises(ValueError):          # inv of the wrong shape
        tb.attn_half_bwd_kernel(x, x, torch.zeros((30, 3)), *aw[:5], NH, T)
    with pytest.raises(ValueError):          # a weight on another device
        tb.mlp_half_fwd_kernel(x, g, b, m["fc_w"].to("meta"), *mw[3:])
    with pytest.raises(RuntimeError):
        tb.attn_half(x.to("meta"), *aw, NH, T)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_bf16_attention_half_refuses_heads_wider_than_64(which):
    """The bf16 tensor-core cores take heads up to 64 wide; both attention
    entry points refuse a wider one before any kernel is built."""
    xw = torch.zeros((3 * T, 72), dtype=torch.bfloat16)
    ws = (torch.ones(72), torch.zeros(72), torch.zeros((72, 216)),
          torch.zeros(216), torch.zeros((72, 72)))
    with pytest.raises(ValueError, match="up to 64 wide"):
        if which == "forward":
            tb.attn_half_fwd_kernel(xw, *ws, torch.zeros(72), 1, T)
        else:
            tb.attn_half_bwd_kernel(xw, xw, torch.zeros((3 * T, 1)), *ws, 1,
                                    T)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["attn", "mlp"])
def test_forward_launch_pieces_chain_to_the_plain_halves(blocks, which, dt):
    """The plain versions of the forward chains' launches one at a time
    (the LayerNorm, `product_plain` of kinds bias, bias_residual and
    bias_gelu, `_attn_core_fwd`), chained as attn_half_fwd and
    mlp_half_fwd launch them, equal the halves' plain versions bit for
    bit: what the card holds each launch against composes to what it holds
    the entry points against."""
    _, td = DTYPES[dt]
    p = tm.cast_weights(blocks[1][0], td)
    x = torch.tensor(_inputs(3 * T, seed=4)[0]).to(td)
    if which == "attn":
        a, ln = p["attn"], p["ln_1"]
        h = tb._ln(x, ln["g"], ln["b"])[0]
        qkv = tb.product_plain(h, a["in_w"], "bias", a["in_b"])
        o, inv = tb._attn_core_fwd(qkv, NH, T)
        y = tb.product_plain(o, a["out_w"], "bias_residual", a["out_b"], x)
        y_r, inv_r = tb.attn_half_fwd_plain(x, ln["g"], ln["b"], a["in_w"],
                                            a["in_b"], a["out_w"],
                                            a["out_b"], NH, T)
        assert torch.equal(inv, inv_r)
    else:
        m, ln = p["mlp"], p["ln_2"]
        h = tb._ln(x, ln["g"], ln["b"])[0]
        act = tb.product_plain(h, m["fc_w"], "bias_gelu", m["fc_b"])
        y = tb.product_plain(act, m["proj_w"], "bias_residual", m["proj_b"],
                             x)
        y_r = tb.mlp_half_fwd_plain(x, ln["g"], ln["b"], m["fc_w"],
                                    m["fc_b"], m["proj_w"], m["proj_b"])
    assert y.dtype == td and torch.equal(y, y_r)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bias_residual", "bias_gelu"])
def test_forward_product_pieces_match_jax(kind, dt):
    """The two forward epilogues of `product_plain` against the TPU
    kernels' own pieces: x + _matmul_bias(o, w, b) (the residual add of
    the two halves) and _quick_gelu_f32(_matmul_bias(h, fc_w, fc_b))
    rounded to dt (the MLP's fc).  float32 within 1e-5 of the largest
    entry; bf16 within one step (both round at the same points)."""
    jd, td = DTYPES[dt]
    rs = np.random.RandomState(3)
    a = rs.randn(30, D).astype(np.float32)
    w = (rs.randn(D, 4 * D) * D ** -0.5).astype(np.float32)
    b = (rs.randn(4 * D) * 0.02).astype(np.float32)
    x = rs.randn(30, 4 * D).astype(np.float32)
    ja, jw, jbias, jx = (jnp.asarray(v).astype(jd) for v in (a, w, b, x))
    ta, tw, tbias, tx = (torch.tensor(v).to(td) for v in (a, w, b, x))
    if kind == "bias_residual":
        want = jx + jb._matmul_bias(ja, jw, jbias)
        got = tb.product_plain(ta, tw, kind, tbias, tx)
    else:
        u = jb._matmul_bias(ja, jw, jbias).astype(jnp.float32)
        want = jb._quick_gelu_f32(u)[0].astype(jd)
        got = tb.product_plain(ta, tw, kind, tbias)
    assert got.dtype == td and got.shape == want.shape
    if dt == "float32":
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=1e-5 * np.abs(_np(want)).max())
    else:
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,heads", [(13, 40, 2), (50, 32, 2),
                                       (80, 128, 2)])
def test_attn_core_fwd_matches_jax_core(t, d, heads, dt):
    """`_attn_core_fwd`, the plain version the card holds its
    tensor-core core forward against, against JAX's
    pallas_block._attn_fwd_core called directly on one sample's qkv
    [t, 3d] (bias 0.0): a 20-wide head at t = 13, one 64-key tile at 50,
    two at 80.  The port saves each row's log-sum-exp, JAX 1 / rowsum:
    exp(-lse) within 1e-5 relative to each entry of JAX's (float32 row
    sums of the float32 e on both sides); o in float32 within 1e-5 of the
    largest entry, in bf16 within one step (both round e before e v, the
    port's e a power of two below JAX's)."""
    jd, td = DTYPES[dt]
    qkv = np.random.RandomState(t).randn(t, 3 * d).astype(np.float32)
    o_j, inv_j = jb._attn_fwd_core(jnp.asarray(qkv).astype(jd), 0.0, heads,
                                   jd)
    o_t, lse_t = tb._attn_core_fwd(torch.tensor(qkv).to(td), heads, t)
    assert o_t.dtype == td and lse_t.dtype == torch.float32
    assert o_t.shape == (t, d) and lse_t.shape == (t, heads)
    np.testing.assert_allclose(_np(torch.exp(-lse_t)), _np(inv_j), rtol=1e-5)
    if dt == "float32":
        np.testing.assert_allclose(_np(o_t), _np(o_j),
                                   atol=1e-5 * np.abs(_np(o_j)).max())
    else:
        _assert_bf16_close(o_t, o_j)


def test_library_names_follow_the_source_and_the_shared_headers(
        tmp_path, monkeypatch):
    """csrc/block.cu includes csrc/mma.cuh, csrc/attn_tile.cuh and
    csrc/wgmma.cuh, and csrc/cutout_win.cu csrc/wgmma.cuh: a library's
    file name hashes its source and every header, so an edit to either
    rebuilds it and a stale library never loads."""
    from aphantasia_torch import kernels
    for name, header in (("block", "mma.cuh"), ("block", "attn_tile.cuh"),
                         ("block", "wgmma.cuh"), ("cutout_win", "wgmma.cuh")):
        src = open(f"{kernels.CSRC}/{name}.cu").read()
        assert f'#include "{header}"' in src
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    (tmp_path / "a.cu").write_text("int a;")
    (tmp_path / "h.cuh").write_text("int h;")
    names = [kernels._lib_path("a")]
    (tmp_path / "h.cuh").write_text("int h2;")
    names.append(kernels._lib_path("a"))
    (tmp_path / "a.cu").write_text("int a2;")
    names.append(kernels._lib_path("a"))
    assert len(set(names)) == 3
    assert all(n.endswith(".so") and "/liba-" in n for n in names)
