"""The port's windowed cutout (aphantasia_torch/ops/cutout_win.py and the
windowed path of ops/sampler.py) against the JAX package's
pallas_cutout_win (interpret mode on the CPU) and its sampler under
APHANTASIA_WIN_CUTOUT=1, on the same JAX-drawn boxes.

Tolerances: the tier plan, the window bases and the windowed weights are
integer-exact or built by the same float32 additions, so they are held
equal.  The windowed forward in float32 is held to 1e-5 relative to the
largest output (sum orders differ).  In bf16 both sides sum the first
product in float32 from the same bf16 values and round it to bf16, so a
sum that lands near a rounding boundary may round the other way: 2^-8 of
the largest output, one bf16 rounding step.  The gradient is the dense
float32-summed transpose on both sides: 1e-5 relative in float32, and in
bf16 1e-3 relative (its bf16-rounded d_tmp may round the other way too).
The CUDA kernel is held against the plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py's kernel phase).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops import pallas_cutout_win as jw
from aphantasia_tpu.ops.sampler import CutoutSampler as JSampler
from aphantasia_torch.ops import cutout_win as tw
from aphantasia_torch.ops.sampler import Boxes, CutoutSampler

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FRAMES = [(0, (96, 160)), (1, (720, 1280)), (2, (64, 64))]


def _draw(h, w, s, m, seed, align="uniform"):
    js = JSampler((h, w), s, m, align, 0.4)
    boxes = js.sample_boxes(jax.random.PRNGKey(seed))
    tb = Boxes(*(torch.as_tensor(np.array(b)) for b in boxes))
    return js, boxes, CutoutSampler((h, w), s, m, align, 0.4), tb


def _rel(a, b):
    return np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max() \
        / np.abs(np.asarray(b, np.float32)).max()


@pytest.mark.parametrize("seed,hw", FRAMES)
def test_tier_plan_and_window_bases_match_jax(seed, hw):
    h, w = hw
    m = 32 if min(h, w) < 200 else 224
    assert tw.tier_plan(h, w, m) == jw.tier_plan(h, w, m)
    _, boxes, _, tb = _draw(h, w, 64, m, seed)
    for a, b in zip(jw.window_bases(boxes, h, w, m),
                    tw.window_bases(tb, h, w, m)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed,hw", FRAMES)
def test_window_bases_cover_all_taps(seed, hw):
    """Every bicubic tap of every drawn box lands inside its sample's tier
    window after rebasing, so the kernel's window drops no weight."""
    h, w = hw
    m = 32 if min(h, w) < 200 else 224
    _, _, ts, tb = _draw(h, w, 64, m, seed)
    yidx, _, xidx, _ = ts.tap_indices(tb)
    tier, rb, cb = tw.window_bases(tb, h, w, m)
    plan = tw.tier_plan(h, w, m)
    k_h = torch.tensor([p[1] for p in plan])[tier.long()]
    k_w = torch.tensor([p[2] for p in plan])[tier.long()]
    yloc = yidx - rb[:, None, None]
    xloc = xidx - cb[:, None, None]
    assert bool((yloc >= 0).all() and (yloc < k_h[:, None, None]).all())
    assert bool((xloc >= 0).all() and (xloc < k_w[:, None, None]).all())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_weight_matrices_windowed_match_jax(dt):
    jd, td = DTYPES[dt]
    js, boxes, ts, tb = _draw(96, 160, 12, 32, 6)
    for a, b in zip(js.weight_matrices_windowed(boxes, dtype=jd),
                    ts.weight_matrices_windowed(tb, dtype=td)):
        assert b.dtype == td
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_windowed_plain_matches_jax_kernel(dt):
    """The plain windowed forward against the Pallas kernel (interpret
    mode) at 96x160, S = 12, M = 32, on a draw that spans tiers."""
    jd, td = DTYPES[dt]
    h, w, s, m = 96, 160, 12, 32
    js, boxes, ts, tb = _draw(h, w, s, m, 6)
    tier = tw.window_bases(tb, h, w, m)[0]
    assert len(set(tier.tolist())) > 1
    img = np.random.RandomState(5).randn(3, h, w).astype(np.float32)
    wyw, wxt = js.weight_matrices_windowed(boxes, dtype=jd)
    ref = jw.windowed_cut_fwd(jnp.asarray(img).astype(jd), boxes, wyw, wxt, m,
                              compute_dtype=jd)
    twyw, twxt = ts.weight_matrices_windowed(tb, dtype=td)
    got = tw.windowed_cut_fwd(torch.tensor(img).to(td), tb, twyw, twxt, m,
                              compute_dtype=td)
    assert got.dtype == torch.float32 and got.shape == (s, 3, m, m)
    assert _rel(got.numpy(), ref) <= (1e-5 if dt == "float32" else 2 ** -8)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cut_under_the_switch_matches_jax(monkeypatch, dt):
    """`sampler.cut` forward and image gradient under APHANTASIA_WIN_CUTOUT=1
    in both packages: the windowed forward and the dense transpose."""
    jd, td = DTYPES[dt]
    h, w, s, m = 96, 160, 12, 32
    js, boxes, ts, tb = _draw(h, w, s, m, 6)
    img = np.random.RandomState(5).randn(3, h, w).astype(np.float32)
    co = np.random.RandomState(7).randn(s, 3, m, m).astype(np.float32)
    monkeypatch.setenv("APHANTASIA_WIN_CUTOUT", "1")
    assert js._win_eligible(jnp.asarray(img), jd)
    assert ts._win_eligible(torch.tensor(img), td)
    out_j, vjp = jax.vjp(lambda x: js.cut(x, boxes, compute_dtype=jd),
                         jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(co))
    x = torch.tensor(img, requires_grad=True)
    out_t = ts.cut(x, tb, compute_dtype=td)
    assert type(out_t.grad_fn).__name__ == "_WinCutBackward"
    (g_t,) = torch.autograd.grad(out_t, x, torch.tensor(co))
    assert _rel(out_t.detach().numpy(), out_j) <= (
        1e-5 if dt == "float32" else 2 ** -8)
    assert _rel(g_t.numpy(), g_j) <= (1e-5 if dt == "float32" else 1e-3)


@pytest.mark.parametrize("case", ["off", "on", "overscan", "chunk",
                                  "f32-720p", "bf16-720p"])
def test_win_eligible_matches_jax(monkeypatch, case):
    """The gate takes the same decisions as the JAX package's: the switch,
    no overscan, no chunking, and the 6.5 MB budget of the frame in the
    compute dtype (a 720x1280 frame fits in bf16, not in float32)."""
    h, w, align, chunk, jd, td = 96, 160, "uniform", 0, jnp.float32, \
        torch.float32
    if case == "overscan":
        align = "overscan"
    if case == "chunk":
        chunk = 4
    if case.endswith("720p"):
        h, w = 720, 1280
    if case.startswith("bf16"):
        jd, td = jnp.bfloat16, torch.bfloat16
    if case != "off":
        monkeypatch.setenv("APHANTASIA_WIN_CUTOUT", "1")
    else:
        monkeypatch.delenv("APHANTASIA_WIN_CUTOUT", raising=False)
    js = JSampler((h, w), 12, 32, align, 0.4, chunk=chunk)
    ts = CutoutSampler((h, w), 12, 32, align, 0.4, chunk=chunk)
    want = js._win_eligible(jnp.zeros((3, h, w)), jd)
    assert ts._win_eligible(torch.zeros((3, h, w)), td) == want
    assert want == (case in ("on", "bf16-720p"))


@pytest.mark.parametrize("seed,hw", FRAMES + [(3, (200, 300))])
def test_window_bases_and_geometry_build_no_host_tables(monkeypatch, seed,
                                                        hw):
    """window_bases and _geometry make no tensor from a Python list (on the
    card that is a pageable copy that syncs and breaks a CUDA graph
    capture) and still equal JAX's window_bases and its tier table, also
    on a frame whose width is not a multiple of 8."""
    h, w = hw
    m = 32 if min(h, w) < 300 else 224
    _, boxes, _, tb = _draw(h, w, 64, m, seed)
    want = [np.asarray(a) for a in jw.window_bases(boxes, h, w, m)]
    plan = jw.tier_plan(h, w, m)

    def no_table(*args, **kwargs):
        raise AssertionError("a tensor made from host data")
    monkeypatch.setattr(torch, "tensor", no_table)
    monkeypatch.setattr(torch, "as_tensor", no_table)
    bases = tw.window_bases(tb, h, w, m)
    geo = tw._geometry(bases, tw.tier_plan(h, w, m))
    monkeypatch.undo()
    for a, b in zip(want, bases):
        np.testing.assert_array_equal(b.numpy(), a)
    tier = want[0]
    dims = np.array([p[1:] for p in plan], np.int32)[tier]
    assert geo.dtype == torch.int32 and geo.is_contiguous()
    np.testing.assert_array_equal(
        geo.numpy(), np.stack([want[1], want[2], dims[:, 0], dims[:, 1]], 1))


def test_tma_pad_leaves_a_multiple_of_8_as_it_is():
    img = torch.rand((3, 96, 160))
    assert tw.tma_pad(img) is img


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_tma_pad_adds_only_zero_columns(dt):
    """A 300-column frame gains 4 zero columns; the plain windowed forward
    from the padded frame equals the one from the frame itself (the
    window reads zeros past W either way, and the tiers, which depend on
    ceil128(W), do not move)."""
    _, td = DTYPES[dt]
    h, w, s, m = 200, 300, 12, 32
    _, _, ts, tb = _draw(h, w, s, m, 8)
    img = torch.tensor(np.random.RandomState(9).randn(3, h, w)
                       .astype(np.float32)).to(td)
    padded = tw.tma_pad(img)
    assert padded.shape == (3, h, 304)
    assert torch.equal(padded[..., :w], img)
    assert not padded[..., w:].any()
    assert tw.tier_plan(h, 304, m) == tw.tier_plan(h, w, m)
    wyw, wxt = ts.weight_matrices_windowed(tb, dtype=td)
    a = tw.windowed_cut_fwd_plain(img, tb, wyw, wxt, m, td)
    b = tw.windowed_cut_fwd_plain(padded, tb, wyw, wxt, m, td)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_windowed_cut_computes_the_bases_once(monkeypatch, dt):
    """One windowed `sampler.cut` computes window_bases once: the weights
    and the forward share them."""
    from aphantasia_torch.ops import sampler as tsampler
    _, td = DTYPES[dt]
    h, w, s, m = 96, 160, 12, 32
    _, _, ts, tb = _draw(h, w, s, m, 6)
    calls = []
    real = tw.window_bases

    def counted(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(tsampler, "window_bases", counted)
    monkeypatch.setattr(tw, "window_bases", counted)
    monkeypatch.setenv("APHANTASIA_WIN_CUTOUT", "1")
    img = torch.rand((3, h, w))
    out = ts.cut(img.requires_grad_(True), tb, compute_dtype=td)
    assert type(out.grad_fn).__name__ == "_WinCutBackward"
    assert len(calls) == 1
    monkeypatch.undo()
    want = tw.windowed_cut_fwd_plain(img.detach().to(td), tb,
                                     *ts.weight_matrices_windowed(tb, td), m,
                                     td)
    assert torch.equal(out, want)
