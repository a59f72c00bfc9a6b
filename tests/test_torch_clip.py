"""The port's CLIP towers (aphantasia_torch/models/clip) against the JAX
package on a tiny ViT + text config, with the JAX `clip_init` weights
converted by aphantasia_torch/convert.py.

Float32 on the CPU: the JAX towers run XLA attention here, the port its
plain attention.  Tolerances: 1e-4 relative to the largest embedding (or
image-gradient) entry; sum orders differ across 2 blocks of matmuls.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.models.clip.tokenizer import tokenize as jtokenize
from aphantasia_torch.convert import clip_params_from_numpy
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.models.clip.tokenizer import tokenize as ttokenize

from _torch_parity import tree_np

CFG_KW = dict(name="tiny", embed_dim=32, image_resolution=32,
              vision_layers=2, vision_width=128, vision_patch_size=8,
              transformer_width=64, transformer_heads=2, transformer_layers=2)


@pytest.fixture(scope="module")
def towers():
    jcfg = jm.CLIPConfig(**CFG_KW)
    tcfg = tm.CLIPConfig(**CFG_KW)
    jp = jm.clip_init(jax.random.PRNGKey(0), jcfg)
    tp = clip_params_from_numpy(tree_np(jp))
    return jcfg, jp, tcfg, tp


def _close(a, b, rel=1e-4):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, atol=rel * np.abs(b).max())


def test_encode_image_and_grad_match_jax(towers):
    jcfg, jp, tcfg, tp = towers
    x = np.random.RandomState(0).randn(3, 3, 32, 32).astype(np.float32)
    co = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    out_j, vjp = jax.vjp(lambda im: jm.encode_image(jp, jcfg, im),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm.encode_image(tp, tcfg, xt)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    _close(out_t.detach().numpy(), out_j)
    _close(g_t.numpy(), g_j)


def test_encode_text_matches_jax(towers):
    jcfg, jp, tcfg, tp = towers
    toks = jtokenize(["a lighthouse at dawn", "the sea"])
    np.testing.assert_array_equal(ttokenize(["a lighthouse at dawn",
                                             "the sea"]), toks)
    out_j = jm.encode_text(jp, jcfg, jnp.asarray(toks))
    out_t = tm.encode_text(tp, tcfg, torch.as_tensor(toks))
    _close(out_t.numpy(), out_j)


def test_layers_match_jax():
    x = np.random.RandomState(2).randn(5, 16).astype(np.float32) * 3 + 1
    p = {"g": np.linspace(0.5, 1.5, 16).astype(np.float32),
         "b": np.linspace(-1, 1, 16).astype(np.float32)}
    lj = jm.layer_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    lt = tm.layer_norm(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(tm.quick_gelu(torch.tensor(x)).numpy(),
                               np.asarray(jm.quick_gelu(jnp.asarray(x))),
                               atol=1e-6)


def test_cast_weights_keeps_layernorms_f32(towers):
    _, _, _, tp = towers
    vis = tm.cast_weights(tp["visual"], torch.bfloat16)
    assert vis["conv"].dtype == torch.bfloat16
    assert vis["blocks"][0]["attn"]["in_w"].dtype == torch.bfloat16
    assert vis["ln_pre"]["g"].dtype == torch.float32
    assert vis["blocks"][1]["ln_2"]["b"].dtype == torch.float32


def test_init_shapes_match_jax(towers):
    jcfg, jp, tcfg, tp = towers
    mine = tm.clip_init(torch.Generator().manual_seed(0), tcfg)
    ref = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda a: tuple(a.shape), mine)
    assert got == ref


def test_unported_models_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.load_clip("RN50")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.load_clip("ViT-B/32", weights_path="/nonexistent.pt")
    assert tm.input_resolution("RN50x4") == 288
