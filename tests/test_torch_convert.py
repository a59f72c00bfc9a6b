"""The port's CLIP checkpoint converter (aphantasia_torch/models/clip/
convert.py) against the JAX package's on the same state dicts, and the
weight conversions of aphantasia_torch/convert.py.

The state dicts are written here from a tiny random tree (numpy-seeded):
in the OpenAI naming (as a dict, a plain `torch.save` file, a TorchScript
archive in fp16 like OpenAI's releases, an .npz), in open_clip's
CustomTextCLIP naming and in HuggingFace's.  Trees are held equal leaf
by leaf, exactly, against the JAX converter's output on the same dict.
"""
import numpy as np
import jax
import pytest
import torch

from aphantasia_tpu.models.clip import convert as jconv
from aphantasia_tpu.models.clip import model as jm
from aphantasia_torch import convert as tconvert
from aphantasia_torch.models.clip import convert as tconv
from aphantasia_torch.models.clip import model as tm

from _torch_parity import tree_np

CFG_KW = dict(name="tiny", embed_dim=24, image_resolution=16,
              vision_layers=2, vision_width=32, vision_patch_size=8,
              context_length=12, vocab_size=100, transformer_width=32,
              transformer_heads=2, transformer_layers=2)


def _tree(seed=0):
    """A tiny random ViT tree, every leaf numpy-seeded (the biases and
    LayerNorm gains too, so no leaf is a constant)."""
    cfg = jm.CLIPConfig(**CFG_KW)
    shapes = jax.tree.map(lambda a: a.shape, jm.clip_init(
        jax.random.PRNGKey(0), cfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda s: np.asarray(rs.randn(*s), np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _openai_sd(tree):
    return {k: v.numpy() for k, v in tconv.openai_state_dict(tree).items()}


def _hf_sd(tree):
    """The tree in HuggingFace CLIPModel naming (q, k, v split)."""
    sd = {}

    def blocks(src, dst):
        for i, b in enumerate(src):
            p = f"{dst}.encoder.layers.{i}"
            sd[p + ".layer_norm1.weight"] = b["ln_1"]["g"]
            sd[p + ".layer_norm1.bias"] = b["ln_1"]["b"]
            for j, n in enumerate("qkv"):
                w = b["attn"]["in_w"].T
                d = w.shape[1]
                sd[p + f".self_attn.{n}_proj.weight"] = w[j * d:(j + 1) * d]
                sd[p + f".self_attn.{n}_proj.bias"] = \
                    b["attn"]["in_b"][j * d:(j + 1) * d]
            sd[p + ".self_attn.out_proj.weight"] = b["attn"]["out_w"].T
            sd[p + ".self_attn.out_proj.bias"] = b["attn"]["out_b"]
            sd[p + ".layer_norm2.weight"] = b["ln_2"]["g"]
            sd[p + ".layer_norm2.bias"] = b["ln_2"]["b"]
            sd[p + ".mlp.fc1.weight"] = b["mlp"]["fc_w"].T
            sd[p + ".mlp.fc1.bias"] = b["mlp"]["fc_b"]
            sd[p + ".mlp.fc2.weight"] = b["mlp"]["proj_w"].T
            sd[p + ".mlp.fc2.bias"] = b["mlp"]["proj_b"]
    v, t = tree["visual"], tree["text"]
    e = "vision_model.embeddings."
    width = v["conv"].shape[1]
    sd[e + "patch_embedding.weight"] = v["conv"].T.reshape(width, 3, 8, 8)
    sd[e + "class_embedding"] = v["class_emb"]
    sd[e + "position_embedding.weight"] = v["pos_emb"]
    sd["vision_model.pre_layrnorm.weight"] = v["ln_pre"]["g"]
    sd["vision_model.pre_layrnorm.bias"] = v["ln_pre"]["b"]
    blocks(v["blocks"], "vision_model")
    sd["vision_model.post_layernorm.weight"] = v["ln_post"]["g"]
    sd["vision_model.post_layernorm.bias"] = v["ln_post"]["b"]
    sd["visual_projection.weight"] = v["proj"].T
    sd["text_model.embeddings.token_embedding.weight"] = t["token_embedding"]
    sd["text_model.embeddings.position_embedding.weight"] = \
        t["positional_embedding"]
    blocks(t["blocks"], "text_model")
    sd["text_model.final_layer_norm.weight"] = t["ln_final"]["g"]
    sd["text_model.final_layer_norm.bias"] = t["ln_final"]["b"]
    sd["text_projection.weight"] = t["text_projection"].T
    sd["logit_scale"] = tree["logit_scale"]
    return {k: np.ascontiguousarray(x) for k, x in sd.items()}


def _assert_same(port_tree, jax_tree):
    """Leaf by leaf, exactly, with the same structure; every port leaf a
    C-contiguous float32 tensor."""
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: x, port_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(tree_np(jax_tree)))
    assert len(got) == len(want)
    for path, leaf in got:
        assert isinstance(leaf, torch.Tensor) and leaf.is_contiguous()
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want[path],
                                      err_msg=jax.tree_util.keystr(path))


def _save_jit_archive(sd, path):
    """A dotted-name state dict as nested ScriptModules, saved in fp16:
    the container format of OpenAI's released .pt files."""
    class Leaf(torch.nn.Module):
        def forward(self):
            return torch.zeros(1)
    root = Leaf()
    for name, x in sd.items():
        parts = name.split(".")
        mod = root
        for p in parts[:-1]:
            if not hasattr(mod, p):
                mod.add_module(p, Leaf())
            mod = getattr(mod, p)
        mod.register_parameter(parts[-1], torch.nn.Parameter(
            torch.as_tensor(x).half(), requires_grad=False))
    torch.jit.save(torch.jit.script(root), str(path))


def test_openai_state_dict_matches_jax():
    """The OpenAI naming (merged qkv [3d, d], conv1 [width, 3, p, p]) ->
    the same tree as the JAX converter, and that tree is the one the
    state dict was written from."""
    tree = _tree()
    sd = _openai_sd(tree)
    got = tconv.convert_checkpoint(sd)
    _assert_same(got, jconv.convert_checkpoint(sd))
    _assert_same(got, tree)


def test_hf_state_dict_matches_jax():
    """HuggingFace's separate q/k/v are merged as the JAX converter merges
    them; the tree equals the one the dict was written from."""
    tree = _tree(1)
    sd = _hf_sd(tree)
    got = tconv.convert_checkpoint(sd)
    _assert_same(got, jconv.convert_hf_clip(sd))
    _assert_same(got, tree)


def test_custom_text_state_dict_matches_jax():
    """open_clip's CustomTextCLIP: the `text.` prefix and a Linear text
    projection without bias ([embed_dim, width]); with a bias it raises
    in both packages."""
    tree = _tree(2)
    sd = {("text." + k if not k.startswith(("visual.", "logit_scale"))
           else k): v for k, v in _openai_sd(tree).items()}
    sd["text.text_projection.weight"] = np.ascontiguousarray(
        sd.pop("text.text_projection").T)
    got = tconv.convert_checkpoint(sd)
    _assert_same(got, jconv.convert_checkpoint(sd))
    _assert_same(got, tree)
    sd["text.text_projection.bias"] = np.zeros(24, np.float32)
    for conv in (tconv.convert_checkpoint, jconv.convert_checkpoint):
        with pytest.raises(ValueError, match="biased Linear"):
            conv(sd)


@pytest.mark.parametrize("fmt", ["jit", "pt", "npz"])
def test_checkpoint_files_load(tmp_path, monkeypatch, fmt):
    """A TorchScript archive (fp16, read back as float32), a plain
    `torch.save` state dict and an .npz give the converter's tree of the
    same dict (the fp16 archive: of its fp16-rounded values), through
    `load_clip` with an explicit path and through APHANTASIA_CLIP_PT."""
    tree = _tree(3)
    sd = _openai_sd(tree)
    path = str(tmp_path / f"tiny.{fmt}")
    if fmt == "jit":
        _save_jit_archive(sd, path)
        sd = {k: v.astype(np.float16).astype(np.float32)
              for k, v in sd.items()}
    elif fmt == "pt":
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    else:
        np.savez(path, **sd)
    want = jconv.convert_checkpoint(sd)
    monkeypatch.setitem(tm.CLIP_CONFIGS, "tiny", tm.CLIPConfig(**CFG_KW))
    monkeypatch.setattr(tm, "PORTED_MODELS", tm.PORTED_MODELS + ("tiny",))
    params, cfg = tm.load_clip("tiny", path)
    assert cfg.name == "tiny"
    _assert_same(params, want)
    monkeypatch.setenv("APHANTASIA_CLIP_PT", path)
    _assert_same(tm.load_clip("tiny")[0], want)
    if fmt == "jit":
        _assert_same(tconv.convert_checkpoint(path), jconv.convert_checkpoint(
            path))


def test_wrong_model_raises_readable_error():
    """A checkpoint of another shape than the model asked for names what
    differs, in both packages."""
    sd = _openai_sd(_tree())
    for conv, cfgs in ((tconv, tm.CLIP_CONFIGS), (jconv, jm.CLIP_CONFIGS)):
        with pytest.raises(ValueError, match="does not match CLIP model "
                           "'ViT-B/32'.*text width 32 != 512"):
            conv.convert_checkpoint(sd, expect_cfg=cfgs["ViT-B/32"])


def test_resnet_checkpoint_raises_until_ported():
    """A ModifiedResNet checkpoint (no class embedding, `visual.layer*`),
    which raised until its tower was ported (ROADMAP A.5), converts: a
    tiny ResNet tree of numpy-seeded leaves (the BatchNorm statistics
    too), written in the OpenAI layout from the port's tree, reads in the
    port exactly as the JAX converter's tree turned into the port's (its
    convolutions HWIO -> OIHW by `clip_params_from_numpy`)."""
    kw = dict(CFG_KW, vision_layers=(1, 2, 1, 1), vision_width=8,
              vision_patch_size=0, image_resolution=64)
    shapes = jax.tree.map(lambda a: a.shape, jm.clip_init(
        jax.random.PRNGKey(0), jm.CLIPConfig(**kw)))
    rs = np.random.RandomState(5)
    tree = jax.tree.map(lambda s: np.abs(rs.randn(*s)).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    sd = _openai_sd(tconvert.clip_params_from_numpy(tree))
    assert "visual.class_embedding" not in sd
    assert sd["visual.layer2.0.downsample.0.weight"].shape == (64, 32, 1, 1)
    got = tconv.convert_checkpoint(sd, expect_cfg=tm.CLIPConfig(**kw))
    want = tconvert.clip_params_from_numpy(tree_np(jconv.convert_checkpoint(
        sd, expect_cfg=jm.CLIPConfig(**kw))))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want), strict=True):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, b), jax.tree_util.keystr(path)
    np.testing.assert_array_equal(
        got["visual"]["layers"][1][1]["bn2"]["v"].numpy(),
        tree["visual"]["layers"][1][1]["bn2"]["v"])


def test_weights_carried_across():
    """convert.py's LPIPS (HWIO -> OIHW), aesthetic, DWT-list and optax
    list-state conversions keep every value."""
    import optax
    from aphantasia_tpu.models.lpips import lpips_init
    rs = np.random.RandomState(4)
    lp = tree_np(lpips_init(jax.random.PRNGKey(0)))
    got = tconvert.lpips_params_from_numpy(lp)
    for c, want in zip(got["convs"], lp["convs"]):
        assert c["w"].is_contiguous()
        np.testing.assert_array_equal(c["w"].numpy(),
                                      want["w"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(c["b"].numpy(), want["b"])
    for a, b in zip(got["lins"], lp["lins"]):
        np.testing.assert_array_equal(a.numpy(), b)
    head = {"w": rs.randn(8, 1).astype(np.float32),
            "b": rs.randn(1).astype(np.float32)}
    for k, v in tconvert.aesthetic_params_from_numpy(head).items():
        np.testing.assert_array_equal(v.numpy(), head[k])
    pyr = [rs.randn(1, 3, 4, 5).astype(np.float32),
           rs.randn(1, 3, 3, 6, 7).astype(np.float32)]
    tp = tconvert.dwt_params_from_numpy(pyr)
    for a, b in zip(tp, pyr):
        np.testing.assert_array_equal(a.numpy(), b)
    opt = optax.adam(0.1, b1=0.0)
    st = opt.init([jax.numpy.asarray(p) for p in pyr])
    _, st = opt.update([jax.numpy.asarray(p) for p in pyr], st)
    ts = tconvert.opt_state_from_optax(st)
    assert int(ts.count) == 1 and isinstance(ts.mu, list)
    adam = [s for s in st if hasattr(s, "nu")][0]
    for a, b in zip(ts.nu, adam.nu):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

