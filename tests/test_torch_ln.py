"""The port's fused LayerNorm (aphantasia_torch/ops/ln.py) against the JAX
package's pallas_ln.layer_norm_fused (interpret mode on the CPU), called
directly: the JAX tower binds APHANTASIA_PALLAS_LN at import.

Inputs are made with numpy from seeds, as the JAX test makes its own:
x ~ 2 N(0, 1) + 0.5 in the working dtype, g ~ 1 + N(0, 0.5), b ~ N(0, 0.1)
in float32.  Tolerances are the JAX test's (tests/test_pallas_ln.py): y
within 1e-5 in float32 and 3e-2 in bf16 (values up to ~12, one bf16
rounding step is 2^-5 there); dx, dg and db within 1e-4 (float32) or
5e-2 (bf16) absolute plus 1e-2 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops import pallas_ln as jln
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import ln as tln

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    """float32 numpy of a JAX array or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _inputs(r, d, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(r, d) * 2 + 0.5).astype(np.float32),
            (rs.randn(d) * 0.5 + 1.0).astype(np.float32),
            (rs.randn(d) * 0.1).astype(np.float32),
            rs.randn(r, d).astype(np.float32))


@pytest.mark.parametrize("r", [1024, 1201])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layer_norm_fused_matches_jax(r, dt):
    jd, td = DTYPES[dt]
    d = 256
    x, g, b, co = _inputs(r, d)
    jx, jco = jnp.asarray(x).astype(jd), jnp.asarray(co).astype(jd)
    assert jln.eligible(jx, jnp.asarray(g))
    y_j, vjp = jax.vjp(jln.layer_norm_fused, jx, jnp.asarray(g),
                       jnp.asarray(b))
    gx_j, gg_j, gb_j = vjp(jco)

    tx = torch.tensor(x).to(td).requires_grad_(True)
    tg = torch.tensor(g, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    assert tln.eligible(tx, tg)
    y_t = tln.layer_norm_fused(tx, tg, tb)
    gx_t, gg_t, gb_t = torch.autograd.grad(y_t, (tx, tg, tb),
                                           torch.tensor(co).to(td))
    assert y_t.dtype == td and gx_t.dtype == td
    assert gg_t.dtype == torch.float32 and gb_t.dtype == torch.float32
    np.testing.assert_allclose(_np(y_t), _np(y_j),
                               atol=1e-5 if dt == "float32" else 3e-2)
    tol = dict(atol=1e-4 if dt == "float32" else 5e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(gx_t), _np(gx_j), **tol)
    np.testing.assert_allclose(_np(gg_t), _np(gg_j), **tol)
    np.testing.assert_allclose(_np(gb_t), _np(gb_j), **tol)


@pytest.mark.parametrize("shape,d", [((4, 50, 768), 768), ((8, 768), 768),
                                     ((4096, 770), 770), ((1023, 256), 256),
                                     ((1024, 256), 256), ((9500, 768), 768)])
def test_eligible_matches_jax(shape, d):
    """2-D only, a width that is a multiple of 128, at least 1024 rows."""
    want = jln.eligible(jnp.zeros(shape), jnp.ones((d,)))
    assert tln.eligible(torch.zeros(shape), torch.ones(d)) == want
    assert want == (shape in ((1024, 256), (9500, 768)))


def test_plain_backward_is_the_vjp_of_the_plain_forward():
    """The closed-form backward equals autograd's transpose of the plain
    forward, float32, within 1e-5 relative."""
    x, g, b, co = _inputs(64, 128, seed=3)
    tx, tg, tb = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    y, stat = tln.ln_fwd_plain(tx, tg, tb)
    want = torch.autograd.grad(y, (tx, tg, tb), torch.tensor(co))
    got = tln.ln_bwd_plain(tx.detach(), tg.detach(), stat.detach(),
                           torch.tensor(co))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(),
                                   atol=1e-5 * w.abs().max().item())


def test_tower_layer_norm_reads_the_switch_at_each_call(monkeypatch):
    """model.layer_norm routes an eligible [rows, D] input through the
    fused function only while APHANTASIA_PALLAS_LN=1, read per call; a 3-D
    input keeps the plain path.  Both give the same values."""
    x, g, b, _ = _inputs(1024, 128, seed=4)
    p = {"g": torch.tensor(g), "b": torch.tensor(b)}
    tx = torch.tensor(x, requires_grad=True)
    monkeypatch.delenv("APHANTASIA_PALLAS_LN", raising=False)
    plain = tm.layer_norm(tx, p)
    assert type(plain.grad_fn).__name__ != "_LayerNormFnBackward"
    monkeypatch.setenv("APHANTASIA_PALLAS_LN", "1")
    fused = tm.layer_norm(tx, p)
    assert type(fused.grad_fn).__name__ == "_LayerNormFnBackward"
    three_d = tm.layer_norm(tx.reshape(8, 128, 128), p)
    assert type(three_d.grad_fn).__name__ != "_LayerNormFnBackward"
    np.testing.assert_allclose(fused.detach().numpy(),
                               plain.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("rows", [1, 7, 16, 17, 131, 132, 133, 1024, 1201,
                                  1799, 4240, 9500, 100000])
def test_backward_blocks_cover_every_row_once(rows):
    """The CUDA backward's grid (`bwd_blocks`, a function of the row count
    alone): one block an H100 SM (132), at most one a row; block b takes
    rows [b rb, b rb + rb) with rb = ceil(rows / blocks), as csrc/ln.cu
    splits them, so every row falls in exactly one block (a block past the
    last row writes zero partial sums)."""
    nblk = tln.bwd_blocks(rows)
    assert nblk == min(rows, 132)
    rb = -(-rows // nblk)
    owner = np.full(rows, -1)
    for b in range(nblk):
        lo, hi = b * rb, min(b * rb + rb, rows)
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = b
    assert (owner >= 0).all()
