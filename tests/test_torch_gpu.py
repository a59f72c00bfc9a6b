"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: float32 attention 2e-5 relative to the largest output (2e-4
on the gradient, float32 sum orders); bf16 attention 2^-7 (both sides
compute in float32 from the same bf16 inputs and round once, so they part
by a rounding step of 2^-8) and five times that on the gradient; cutout
1e-5 forward and 1e-4 relative on the gradient (float32 atomics add in a
run-dependent order).
"""
import pytest
import torch

from aphantasia_torch import kernels
from aphantasia_torch.ops import attention as A
from aphantasia_torch.ops import cutout as C
from aphantasia_torch.ops.sampler import CutoutSampler

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("t,heads,causal,valid_t", [
    (50, 12, False, None), (77, 8, True, None), (64, 12, False, 50),
    (197, 12, False, None), (257, 16, False, None)])
def test_attention_kernel_matches_plain(cuda, dtype, tol, t, heads, causal,
                                        valid_t):
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
    assert _rel(gk, gp) <= 5 * tol


@pytest.mark.parametrize("h,w,s,m", [(720, 1280, 24, 224), (40, 56, 6, 64)])
def test_cutout_kernel_matches_plain(cuda, h, w, s, m):
    """Also a frame smaller than the crops (40x56 < 64): out-of-frame taps
    carry no weight."""
    sampler = CutoutSampler((h, w), s, m, "uniform", 0.4, use_pallas=True)
    taps = sampler.tap_indices(sampler.sample_boxes(cuda))
    img = torch.rand((3, h, w), generator=cuda, device="cuda",
                     requires_grad=True)
    co = torch.randn((s, 3, m, m), generator=cuda, device="cuda")
    out = C.cutout(img, *taps)
    (gk,) = torch.autograd.grad(out, img, co)
    ref = C.cutout_plain(img, *taps)
    (gp,) = torch.autograd.grad(ref, img, co)
    assert (out - ref).abs().max().item() <= 1e-5
    assert _rel(gk, gp) <= 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        A.attention(torch.zeros((10, 48), device="cuda",
                                dtype=torch.float16), 2, 5)
    with pytest.raises(ValueError, match="shared memory"):
        A.attention_bwd_kernel(*(4 * [torch.zeros((2 * 420, 3 * 1024),
                                                  device="cuda")]), 16, 420)
