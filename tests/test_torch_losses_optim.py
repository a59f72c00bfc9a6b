"""The port's losses and optimizers (aphantasia_torch/ops/{losses,optim}.py)
against the JAX package's losses and optax chains, in float32.

Tolerances: similarity values and their gradients 1e-5 (a handful of
float32 reductions); sharpness 1e-5; optimizer params (magnitude ~2)
after 6 steps 1e-5 relative, a few float32 steps (the bias corrections
and the moment updates round in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from aphantasia_tpu.ops import losses as jl
from aphantasia_tpu.ops import optim as jo
from aphantasia_torch.convert import opt_state_from_optax
from aphantasia_torch.ops import losses as tl
from aphantasia_torch.ops import optim as to


@pytest.mark.parametrize("mode", [None, "cossim", "mix", "spherical",
                                  "angular", "dot"])
def test_sim_func_and_grad_match_jax(mode):
    rs = np.random.RandomState(0)
    v1 = rs.randn(1, 16).astype(np.float32)
    v2 = rs.randn(7, 16).astype(np.float32)

    def jf(b):
        return jnp.sum(jl.sim_func(jnp.asarray(v1), b, mode))
    vj, gj = jax.value_and_grad(jf)(jnp.asarray(v2))
    b = torch.tensor(v2, requires_grad=True)
    vt = tl.sim_func(torch.tensor(v1), b, mode).sum()
    (gt,) = torch.autograd.grad(vt, b)
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


@pytest.mark.parametrize("mode", ["naiv", "scharr", "sobel"])
def test_derivat_matches_jax(mode):
    img = np.random.RandomState(1).rand(1, 3, 12, 17).astype(np.float32)
    dj = float(jl.derivat(jnp.asarray(img), mode))
    dt = tl.derivat(torch.tensor(img), mode).item()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,prog", [("adam", False), ("adam_custom", False),
                                       ("adamw", False), ("adamw_custom", False),
                                       ("adam_custom", True)])
def test_optimizers_match_optax(name, prog):
    steps = 6
    rs = np.random.RandomState(2)
    p0 = rs.randn(2, 3, 4).astype(np.float32)
    grads = [rs.randn(2, 3, 4).astype(np.float32) for _ in range(steps)]
    jopt = jo.build_optimizer(name, 0.05, steps, prog)
    jp = jnp.asarray(p0)
    js = jopt.init(jp)
    topt = to.build_optimizer(name, 0.05, steps, prog)
    tp = torch.tensor(p0)
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, torch.tensor(g), ts)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    # the optax state converts to the port's and carries on identically
    conv = opt_state_from_optax(js)
    assert conv.count == steps
    np.testing.assert_allclose(conv.nu.numpy(), ts.nu.numpy(), rtol=1e-5)


def test_lr_schedule_ramp():
    f = to.lr_schedule(0.05, 100, prog=True)
    assert f(0) == pytest.approx(0.001) and f(100) == pytest.approx(0.1)
    assert to.lr_schedule(0.05, 100) == 0.05
    with pytest.raises(ValueError):
        to.build_optimizer("sgd", 0.1)
