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


def test_bf16_tiles_take_head_width_64_at_any_token_count():
    """The dispatch is by dtype: a bf16 stream with head width 64 passes at
    ViT-L/14@336px's t = 577 without asking the library (its shared memory
    is bounded by the tile, not by t); another head width, or a valid_t
    outside [1, t], is refused before any launch."""
    bf = torch.bfloat16
    assert A._fits(torch.zeros((2 * 577, 3 * 1024), dtype=bf), 16) is None
    with pytest.raises(ValueError, match="head width"):
        A._fits(torch.zeros((10, 3 * 64), dtype=bf), 2)
    with pytest.raises(ValueError, match="valid_t"):
        A._check(torch.zeros((10, 3 * 128), dtype=bf), 2, 5, valid_t=6)
    A._check(torch.zeros((10, 3 * 128), dtype=bf), 2, 5, valid_t=5)


def test_float32_tiles_take_any_token_count():
    """The float32 tiles walk keys 64 at a time, so no t is refused (the
    first design held whole [t, hd] matrices and stopped near t = 420);
    only a head wider than the register tiles' 128 is."""
    f32 = torch.float32
    for t in (420, 577, 1024, 4096):
        assert A._fits(torch.zeros((t, 3 * 1024), dtype=f32), 16) is None
    assert A._fits(torch.zeros((4, 3 * 256), dtype=f32), 2) is None
    with pytest.raises(ValueError, match="up to 128"):
        A._fits(torch.zeros((4, 3 * 256), dtype=f32), 1)


def test_long_sequence_matches_jax():
    """ViT-L/14@336px's t = 577 in float32 at a narrow width (b = 2, two
    heads of 16) against the JAX padded core, which the JAX towers take at
    this t (its flat kernel refuses t = 577: `flat_geometry` is None); the
    two layouts are the same memory."""
    b, t, h, hd = 2, 577, 2, 16
    d = h * hd
    x = _qkv(6, b, t, 3 * d)
    co = _qkv(7, b, t, d)
    out_j, vjp = jax.vjp(lambda q: attention_core(q, h), jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    out_t, g_t = _torch_vjp(lambda q: A.attention_core_flat(q, h, t),
                            x.reshape(b * t, 3 * d), co.reshape(b * t, d))
    np.testing.assert_allclose(out_t, np.asarray(out_j).reshape(b * t, d),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(g_t, np.asarray(g_j).reshape(b * t, 3 * d),
                               atol=2e-5, rtol=2e-4)


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
