"""The port's attention core (aphantasia_torch/ops/attention.py) against the
JAX package's Pallas attention (interpret mode on the CPU), forward and
VJP, on the same numpy inputs in float32.

Tolerances are those of tests/test_pallas_attn.py: 2e-5 on the forward,
2e-5 abs / 2e-4 rel on the gradient (float32, different sum orders).
The CUDA kernel itself is held against the same plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py's kernel phase).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.ops.pallas_attn import attention_core, attention_core_flat
from aphantasia_torch.ops import attention as A


def _qkv(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _torch_vjp(fn, x, co):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    (g,) = torch.autograd.grad(out, xt, torch.tensor(co))
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("b,t,h,hd", [(3, 10, 2, 8), (9, 50, 4, 16)])
def test_flat_matches_jax(b, t, h, hd):
    d = h * hd
    x = _qkv(0, b * t, 3 * d)
    co = _qkv(1, b * t, d)
    out_j, vjp = jax.vjp(lambda q: attention_core_flat(q, h, t),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    out_t, g_t = _torch_vjp(lambda q: A.attention_core_flat(q, h, t), x, co)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(g_t, np.asarray(g_j), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_core_matches_jax(causal):
    b, t, h, hd = 3, 16, 4, 16
    d = h * hd
    x = _qkv(2, b, t, 3 * d)
    co = _qkv(3, b, t, d)
    out_j, vjp = jax.vjp(lambda q: attention_core(q, h, causal),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    out_t, g_t = _torch_vjp(lambda q: A.attention_core(q, h, causal), x, co)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(g_t, np.asarray(g_j), atol=2e-5, rtol=2e-4)


def test_valid_t_matches_jax():
    """Keys at and past valid_t are masked; real rows and their gradients
    agree with the JAX kernel on a caller-padded T."""
    b, t_pad, valid, h, hd = 2, 16, 8, 2, 8
    d = h * hd
    x = _qkv(4, b, t_pad, 3 * d)
    co = _qkv(5, b, t_pad, d)
    co[:, valid:] = 0.0          # only real rows are read downstream
    out_j, vjp = jax.vjp(lambda q: attention_core(q, h, False, valid),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    out_t, g_t = _torch_vjp(lambda q: A.attention_core(q, h, False, valid),
                            x, co)
    np.testing.assert_allclose(out_t[:, :valid], np.asarray(out_j)[:, :valid],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(g_t[:, :valid], np.asarray(g_j)[:, :valid],
                               atol=2e-5, rtol=2e-4)


def test_kernel_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        A._check(torch.zeros(10, 3 * 16), 3, 5)        # 16 % 3 heads
    with pytest.raises(TypeError):
        A._check(torch.zeros(10, 48, dtype=torch.float16), 2, 5)


def test_cuda_tensor_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel (here: the autograd Function),
    never to the plain version."""
    calls = []
    monkeypatch.setattr(A._AttentionFn, "apply",
                        lambda *a: calls.append(a) or "kernel")
    monkeypatch.setattr(A, "attention_plain",
                        lambda *a, **k: pytest.fail("plain version used"))

    class FakeCuda:
        is_cuda = True
    assert A.attention(FakeCuda(), 2, 5) == "kernel" and calls
