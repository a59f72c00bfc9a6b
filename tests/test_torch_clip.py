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


def test_image_tower_under_the_ln_switch_matches_jax(towers, monkeypatch):
    """61 cutouts of 17 tokens at width 128 put 1037 rows on the flat
    stream, so under APHANTASIA_PALLAS_LN=1 the port's four block
    LayerNorms take the fused function (ops/ln.py; its plain versions on
    the CPU).  The JAX tower runs under the same switch, but on the CPU it
    keeps its [B, T, D] stream, where its gate does not fire, so it is the
    plain reference here (tests/test_torch_ln.py holds the fused function
    against pallas_ln itself).  Forward and image gradient, 1e-4
    relative."""
    from aphantasia_torch.ops import ln as tln
    jcfg, jp, tcfg, tp = towers
    calls = []
    fused = tln.layer_norm_fused

    def counted(*a, **k):
        calls.append(a[0].shape)
        return fused(*a, **k)
    monkeypatch.setattr(tln, "layer_norm_fused", counted)
    monkeypatch.setattr(jm, "_PALLAS_LN", True)
    monkeypatch.setenv("APHANTASIA_PALLAS_LN", "1")
    x = np.random.RandomState(3).randn(61, 3, 32, 32).astype(np.float32)
    co = np.random.RandomState(4).randn(61, 32).astype(np.float32)
    out_j, vjp = jax.vjp(lambda im: jm.encode_image(jp, jcfg, im),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm.encode_image(tp, tcfg, xt)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    assert calls == [(61 * 17, 128)] * 4
    _close(out_t.detach().numpy(), out_j)
    _close(g_t.numpy(), g_j)


def test_vit_l14_shapes_match_jax(monkeypatch):
    """ViT-L/14 is a ported model: its parameter tree has the JAX
    `clip_init` shapes (from jax.eval_shape; the port's tree is built on
    the meta device, so neither side allocates its 1.7 GB), and the CLI's
    sample budget leaves 7 cutouts of 257 tokens (1799 flat rows)."""
    from aphantasia_torch.cli.common import apply_sample_budget
    assert "ViT-L/14" in tm.PORTED_MODELS
    name = "ViT-L/14"
    ref = jax.eval_shape(lambda k: jm.clip_init(k, jm.CLIP_CONFIGS[name]),
                         jax.random.PRNGKey(0))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    mine = tm.clip_init(torch.Generator(), tm.CLIP_CONFIGS[name])
    assert (jax.tree.map(lambda a: tuple(a.shape), mine)
            == jax.tree.map(lambda a: tuple(a.shape), ref))
    assert apply_sample_budget(200, name) == 7
    cfg = tm.CLIP_CONFIGS[name]
    assert (cfg.image_resolution // cfg.vision_patch_size) ** 2 + 1 == 257


def test_vit_l14_336_shapes_match_jax(monkeypatch):
    """ViT-L/14@336px is a ported tower, which illustra offers: its
    parameter tree has the JAX `clip_init` shapes (both trees shape-only,
    as for ViT-L/14) and its images make 577 tokens, which the bf16
    attention tiles take at any count."""
    name = "ViT-L/14@336px"
    assert name in tm.PORTED_MODELS
    ref = jax.eval_shape(lambda k: jm.clip_init(k, jm.CLIP_CONFIGS[name]),
                         jax.random.PRNGKey(0))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    mine = tm.clip_init(torch.Generator(), tm.CLIP_CONFIGS[name])
    assert (jax.tree.map(lambda a: tuple(a.shape), mine)
            == jax.tree.map(lambda a: tuple(a.shape), ref))
    cfg = tm.CLIP_CONFIGS[name]
    assert tm.input_resolution(name) == 336 == jm.input_resolution(name)
    assert (cfg.image_resolution // cfg.vision_patch_size) ** 2 + 1 == 577


def test_vit_at_the_336_geometry_matches_jax():
    """`vit_encode` at ViT-L/14@336px's geometry (336 px images in 14 px
    patches: 577 tokens) against the JAX tower, at a narrow width (one head
    of 64) and 2 layers: embedding and image gradient, 1e-4 relative (the
    module's float32 tolerance)."""
    kw = dict(CFG_KW, image_resolution=336, vision_patch_size=14,
              vision_width=64)
    jcfg, tcfg = jm.CLIPConfig(**kw), tm.CLIPConfig(**kw)
    jp = jm.clip_init(jax.random.PRNGKey(1), jcfg)
    tp = clip_params_from_numpy(tree_np(jp))
    x = np.random.RandomState(5).randn(2, 3, 336, 336).astype(np.float32)
    co = np.random.RandomState(6).randn(2, 32).astype(np.float32)
    out_j, vjp = jax.vjp(lambda im: jm.encode_image(jp, jcfg, im),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(co))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm.encode_image(tp, tcfg, xt)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(co))
    assert (336 // 14) ** 2 + 1 == 577
    _close(out_t.detach().numpy(), out_j)
    _close(g_t.numpy(), g_j)


def test_vit_at_the_336_geometry_matches_the_benchmark_reference(tmp_path):
    """`vit_encode` at ViT-L/14@336px's geometry (577 tokens; width 64, 4
    heads of 16, 2 layers, 2 images, float32) against the benchmark's
    plain reference (`benchmark/reference/clip.encode_image`), both
    loading one OpenAI-layout state dict of seeded random weights at
    OpenAI's scales (`benchmark/harness/weights.py`): embedding and image
    gradient within 1e-4 of the largest entry, the module's float32
    tolerance (the port's one-pass LayerNorm moments and its own product
    and attention orders against the reference's two-pass `layer_norm`
    and plain softmax)."""
    from aphantasia_torch.models.clip.convert import convert_checkpoint
    from benchmark.harness.weights import write_weights
    from benchmark.reference import clip as ref
    vision = {"image_resolution": 336, "patch_size": 14, "width": 64,
              "layers": 2, "heads": 4}
    config = {"embed_dim": 32, "vision": vision,
              "text": {"context_length": 77, "vocab_size": 49408,
                       "width": 32, "layers": 1, "heads": 2}}
    path = write_weights(config, 2 ** 31 + 9, str(tmp_path), "cpu")["clip"]
    cfg = tm.CLIPConfig("l14-336-narrow", 32, 336, 2, 64, 14,
                        transformer_width=32, transformer_heads=2,
                        transformer_layers=1, vision_heads_override=4)
    params = convert_checkpoint(path, expect_cfg=cfg)
    sd = ref.load_state_dict(path, "cpu")
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 3, 336, 336), generator=gen)
    co = torch.randn((2, 32), generator=gen)
    outs = []
    for fn in (lambda im: tm.encode_image(params, cfg, im),
               lambda im: ref.encode_image(sd, vision, im)):
        xx = x.clone().requires_grad_(True)
        emb = fn(xx)
        (g,) = torch.autograd.grad(emb, xx, co)
        outs.append((emb.detach(), g))
    (e_t, g_t), (e_r, g_r) = outs
    assert (336 // 14) ** 2 + 1 == 577 and cfg.vision_heads == 4
    _close(e_t.numpy(), e_r.numpy())
    _close(g_t.numpy(), g_r.numpy())


def test_unported_models_raise(monkeypatch):
    """Every model is ported since the ModifiedResNets were: the largest,
    RN50x64, builds through `load_clip` (shape-only: its 623M parameters
    on the meta device) with the JAX tree's stage depths and widths, and
    takes 448 px images."""
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    params, cfg = tm.load_clip("RN50x64")
    assert cfg.name == "RN50x64" and not cfg.is_vit
    v = params["visual"]
    assert [len(s) for s in v["layers"]] == [3, 15, 36, 10]
    assert tuple(v["stem"]["conv1_w"].shape) == (64, 3, 3, 3)
    assert tuple(v["attnpool"]["pos_emb"].shape) == (14 * 14 + 1, 4096)
    assert tuple(params["text"]["token_embedding"].shape) == (49408, 1024)
    assert tm.input_resolution("RN50x64") == 448
    assert tm.input_resolution("RN50x4") == 288


def test_unported_models_raise_from_a_checkpoint(tmp_path, monkeypatch):
    """A ModifiedResNet checkpoint in the OpenAI layout (no class
    embedding, `visual.layer*` blocks), written from a tiny ResNet tree,
    loads through `load_clip` (RN50's name, the tiny configuration in its
    place) into the tree it was written from, and its tower encodes; a
    ViT model asked for names the mismatch."""
    from aphantasia_torch.models.clip.convert import openai_state_dict
    cfg = tm.CLIPConfig(**dict(CFG_KW, name="rn", vision_layers=(1, 2, 1, 1),
                               vision_width=8, vision_patch_size=0))
    tree = tm.clip_init(torch.Generator().manual_seed(0), cfg)
    sd = openai_state_dict(tree)
    assert "visual.class_embedding" not in sd
    assert "visual.layer2.1.conv1.weight" in sd
    path = str(tmp_path / "rn.pt")
    torch.save(sd, path)
    monkeypatch.setitem(tm.CLIP_CONFIGS, "RN50", cfg)
    loaded, got_cfg = tm.load_clip("RN50", weights_path=path)
    assert got_cfg is cfg
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree),
                    strict=True):
        assert torch.equal(a, b)
    emb = tm.encode_image(loaded, cfg, torch.randn(2, 3, 32, 32))
    assert emb.shape == (2, 32) and torch.isfinite(emb).all()
    with pytest.raises(ValueError, match="checkpoint is a ResNet"):
        tm.load_clip("ViT-B/32", weights_path=path)
