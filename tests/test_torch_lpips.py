"""The `--sync` and `--aest` pieces of the port against the JAX package's,
on the CPU, from the same numpy-seeded inputs and weights:
`ops/resize.py:resize_bicubic`, `models/lpips.py` (VGG16 + lin heads) and
the aesthetic head of `ops/losses.py`.

Tolerances (float32 on both sides): resize value and input gradient 1e-5;
LPIPS value and input gradient 1e-5 relative to the largest entry (a
thirteen-layer VGG16 of float32 convolutions summed in other orders than
XLA's); the heads, loaded from state dicts this file writes, exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models import lpips as jl
from aphantasia_tpu.ops import losses as jlosses
from aphantasia_tpu.ops.resize import resize_bicubic as jresize
from aphantasia_torch.convert import (aesthetic_params_from_numpy,
                                      lpips_params_from_numpy)
from aphantasia_torch.models import lpips as tl
from aphantasia_torch.ops import losses as tlosses
from aphantasia_torch.ops.resize import resize_bicubic

from _torch_parity import tree_np


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("src,dst", [((40, 56), (20, 28)),
                                     ((33, 47), (16, 23)),
                                     ((12, 9), (31, 20))])
def test_resize_bicubic_matches_jax(src, dst):
    """Down and up, odd sizes: value and input gradient within 1e-5."""
    rs = np.random.RandomState(0)
    x = rs.rand(2, 3, *src).astype(np.float32)
    co = rs.randn(2, 3, *dst).astype(np.float32)
    out_j, vjp = jax.vjp(lambda v: jresize(v, dst), jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    out_t = resize_bicubic(xt, dst)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    assert out_t.shape == (2, 3) + dst
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)


def _lpips_pair(seed=0):
    """JAX random LPIPS weights (biases numpy-seeded, so none is zero) and
    the same weights converted to the port."""
    jp = tree_np(jl.lpips_init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    for c in jp["convs"]:
        c["b"] = (0.05 * rs.randn(*c["b"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), lpips_params_from_numpy(jp)


def test_lpips_apply_matches_jax():
    """2 images of 3x32x48 against 2 targets: the distance [2] and the
    gradient with respect to the images, 1e-5 relative."""
    jp, tp = _lpips_pair()
    rs = np.random.RandomState(1)
    x = rs.rand(2, 3, 32, 48).astype(np.float32)
    y = rs.rand(2, 3, 32, 48).astype(np.float32)
    out_j, vjp = jax.vjp(lambda v: jl.lpips_apply(jp, v, jnp.asarray(y)),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray([1.0, 0.5], jnp.float32))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tl.lpips_apply(tp, xt, torch.tensor(y))
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor([1.0, 0.5]))
    assert out_t.shape == (2,)
    assert _rel(out_t.detach().numpy(), out_j) <= 1e-5
    assert _rel(g_t.numpy(), g_j) <= 1e-5
    same = tl.lpips_apply(tp, torch.tensor(y), torch.tensor(y))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def _lpips_state(seed=2):
    """torchvision VGG16 `features.*` and lpips `lin*` tensors, written
    the way the checkpoints name them."""
    rs = np.random.RandomState(seed)
    vgg, lin, idx, cin = {}, {}, 0, 3
    for v in tl.VGG_CFG:
        if v == "M":
            idx += 1
            continue
        vgg[f"features.{idx}.weight"] = (
            rs.randn(v, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(
                np.float32)
        vgg[f"features.{idx}.bias"] = (0.01 * rs.randn(v)).astype(np.float32)
        cin, idx = v, idx + 2
    for i, c in enumerate(tl.TAP_CHANNELS):
        lin[f"lin{i}.model.1.weight"] = (
            np.abs(rs.randn(1, c, 1, 1)) / c).astype(np.float32)
    return vgg, lin


@pytest.mark.parametrize("fmt", ["pt", "npz", "env"])
def test_lpips_load_matches_jax(tmp_path, monkeypatch, fmt):
    """`lpips_load` on the written tensors equals the JAX `lpips_load`
    carried across (OIHW here, HWIO there); `lpips_get` reads the same
    from a .pt or .npz path, or from APHANTASIA_LPIPS_PT."""
    vgg, lin = _lpips_state()
    want = lpips_params_from_numpy(tree_np(jl.lpips_load(vgg, lin)))
    got = tl.lpips_load({k: torch.tensor(v) for k, v in vgg.items()}, lin)
    path = str(tmp_path / f"lpips.{fmt if fmt != 'env' else 'pt'}")
    if fmt == "npz":
        np.savez(path, **vgg, **lin)
    else:
        torch.save({k: torch.tensor(v) for k, v in {**vgg, **lin}.items()},
                   path)
    if fmt == "env":
        monkeypatch.setenv("APHANTASIA_LPIPS_PT", path)
        path = None
    read = tl.lpips_get(torch.Generator().manual_seed(0), path)
    for tree in (got, read):
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
            assert torch.equal(a, b)


def test_lpips_random_init_shapes(monkeypatch):
    """Without a checkpoint: the JAX tree's shapes (OIHW), and a finite,
    differentiable distance."""
    monkeypatch.delenv("APHANTASIA_LPIPS_PT", raising=False)
    tp = tl.lpips_get(torch.Generator().manual_seed(0))
    jp = lpips_params_from_numpy(tree_np(jl.lpips_init(
        jax.random.PRNGKey(0))))
    assert ([tuple(a.shape) for a in jax.tree.leaves(tp)]
            == [tuple(a.shape) for a in jax.tree.leaves(jp)])
    x = torch.rand((1, 3, 32, 32), requires_grad=True)
    d = tl.lpips_apply(tp, x, torch.rand((1, 3, 32, 32)))
    (g,) = torch.autograd.grad(d.sum(), x)
    assert torch.isfinite(d).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("model", ["ViT-B/32", "ViT-B/16", "ViT-L/14",
                                   "RN50"])
def test_aesthetic_head_matches_jax(tmp_path, monkeypatch, model):
    """The head's width per model (none for RN50); a `Linear(nf, 1)` state
    dict loads as the JAX `aesthetic_load` reads it (exactly), by path and
    by APHANTASIA_AEST_PT, and scores embeddings as `aesthetic_apply`
    does (1e-6); without weights the random head has the JAX shapes."""
    nf = tlosses.aesthetic_dims(model)
    assert nf == jlosses.aesthetic_dims(model)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.delenv("APHANTASIA_AEST_PT", raising=False)
    if nf is None:
        assert tlosses.aesthetic_get(gen, model) is None
        return
    lin = torch.nn.Linear(nf, 1)
    path = str(tmp_path / "aest.pth")
    torch.save(lin.state_dict(), path)
    want = aesthetic_params_from_numpy(tree_np(jlosses.aesthetic_load(path)))
    got = tlosses.aesthetic_get(gen, model, path)
    monkeypatch.setenv("APHANTASIA_AEST_PT", path)
    via_env = tlosses.aesthetic_get(gen, model)
    for k in ("w", "b"):
        assert torch.equal(got[k], want[k]) and torch.equal(via_env[k],
                                                            want[k])
    emb = np.random.RandomState(3).randn(5, nf).astype(np.float32)
    score = tlosses.aesthetic_apply(got, torch.tensor(emb))
    np.testing.assert_allclose(
        score.detach().numpy(),
        np.asarray(jlosses.aesthetic_apply(jlosses.aesthetic_load(path),
                                           jnp.asarray(emb))), atol=1e-6)
    monkeypatch.delenv("APHANTASIA_AEST_PT")
    rand = tlosses.aesthetic_get(gen, model)
    assert rand["w"].shape == (nf, 1) and rand["b"].shape == (1,)


def test_sync_pieces_make_no_host_tables_after_the_first(monkeypatch):
    """The resize matrices and LPIPS's input constants are built once per
    size and device: a second call makes no tensor from host data (on
    the card a pageable copy, which a CUDA graph's capture refuses)."""
    from test_torch_loop import _forbid_host_tables
    _, tp = _lpips_pair()
    x = torch.rand((1, 3, 40, 56))
    y = torch.rand((1, 3, 20, 28))

    def call():
        return tl.lpips_apply(tp, resize_bicubic(x, (20, 28)), y)
    first = call()
    _forbid_host_tables(monkeypatch)
    again = call()
    monkeypatch.undo()
    assert torch.equal(first, again)
