"""CLIP checkpoints into the port's parameter tree (counterpart of
aphantasia_tpu.models.clip.convert).

Sources (no download is ever needed):
  * OpenAI `clip` release .pt files: TorchScript archives or plain state
    dicts (also open_clip's classic save format, and its CustomTextCLIP
    layout with a `text.`-prefixed text tower);
  * HuggingFace `transformers.CLIPModel` state dicts (ViT);
  * .npz files of either key layout.

The key mapping runs in numpy, as in the JAX package, into the JAX
package's tree layout (linear weights [in, out], merged qkv, the patchify
as a [3*p*p, width] matrix), which `convert.clip_params_from_numpy` turns
into tensors: both packages share one layout.  The ModifiedResNet towers
are not ported (ROADMAP.md A.5): their checkpoints raise.
"""
from __future__ import annotations

import numpy as np
import torch

from aphantasia_torch.convert import clip_params_from_numpy


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _read_state_dict(path: str) -> dict:
    """A checkpoint file -> {key: float32 numpy}: an .npz, a TorchScript
    archive, or a `torch.save`d state dict (tensors only)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: _np(z[k]) for k in z.files}
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not an archive: a saved state dict
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def _ln(sd, prefix):
    return {"g": _np(sd[prefix + ".weight"]), "b": _np(sd[prefix + ".bias"])}


def _block(sd, prefix):
    return {
        "ln_1": _ln(sd, prefix + ".ln_1"),
        "attn": {
            "in_w": _np(sd[prefix + ".attn.in_proj_weight"]).T,
            "in_b": _np(sd[prefix + ".attn.in_proj_bias"]),
            "out_w": _np(sd[prefix + ".attn.out_proj.weight"]).T,
            "out_b": _np(sd[prefix + ".attn.out_proj.bias"]),
        },
        "ln_2": _ln(sd, prefix + ".ln_2"),
        "mlp": {
            "fc_w": _np(sd[prefix + ".mlp.c_fc.weight"]).T,
            "fc_b": _np(sd[prefix + ".mlp.c_fc.bias"]),
            "proj_w": _np(sd[prefix + ".mlp.c_proj.weight"]).T,
            "proj_b": _np(sd[prefix + ".mlp.c_proj.bias"]),
        },
    }


def _resnet_unported():
    return NotImplementedError(
        "ModifiedResNet CLIP checkpoints are not ported to aphantasia_torch "
        "yet (ROADMAP.md A.5)")


def convert_checkpoint(path_or_sd, expect_cfg=None, device="cpu"):
    """Any supported CLIP checkpoint (a path or a state dict) -> the
    parameter tree of tensors on `device`, by the state dict's naming
    (HuggingFace or OpenAI; open_clip's CustomTextCLIP is renamed to the
    OpenAI naming first).  `expect_cfg` (a CLIPConfig) checks the
    checkpoint's shapes against the model asked for, with a readable
    error."""
    sd = (path_or_sd if isinstance(path_or_sd, dict)
          else _read_state_dict(path_or_sd))
    if any(k.startswith(("vision_model.", "text_model.")) for k in sd):
        params = convert_hf_clip(sd)
    else:
        params = convert_openai_checkpoint(_unwrap_custom_text(sd))
    if expect_cfg is not None:
        _verify_cfg(params, expect_cfg)
    return clip_params_from_numpy(params, device)


def _unwrap_custom_text(sd):
    """open_clip CustomTextCLIP -> OpenAI naming: strip the `text.` prefix
    of the text tower; a Linear text projection without bias
    (`text.text_projection.weight`, [embed_dim, width]) is transposed into
    the [width, embed_dim] parameter; with a bias it has no slot and
    raises."""
    if not any(k.startswith("text.") for k in sd):
        return sd
    if "text.text_projection.bias" in sd:
        raise ValueError(
            "CustomTextCLIP checkpoint uses a biased Linear text projection "
            "- no equivalent slot in the OpenAI CLIP parameterization")
    out = {}
    for k, v in sd.items():
        if k == "text.text_projection.weight":
            out["text_projection"] = _np(v).T
        elif k.startswith("text."):
            out[k[len("text."):]] = v
        else:
            out[k] = v
    return out


def _verify_cfg(params, cfg):
    t = params["text"]
    problems = []
    if t["token_embedding"].shape[1] != cfg.transformer_width:
        problems.append(f"text width {t['token_embedding'].shape[1]} != "
                        f"{cfg.transformer_width}")
    if len(t["blocks"]) != cfg.transformer_layers:
        problems.append(
            f"text layers {len(t['blocks'])} != {cfg.transformer_layers}")
    if t["text_projection"].shape[1] != cfg.embed_dim:
        problems.append(
            f"embed dim {t['text_projection'].shape[1]} != {cfg.embed_dim}")
    v = params["visual"]
    if cfg.is_vit:
        if len(v["blocks"]) != cfg.vision_layers:
            problems.append(
                f"vision layers {len(v['blocks'])} != {cfg.vision_layers}")
        pp = 3 * cfg.vision_patch_size ** 2
        if v["conv"].shape[0] != pp:
            problems.append(f"patch size: conv rows {v['conv'].shape[0]} "
                            f"!= {pp}")
    else:
        problems.append("checkpoint is a ViT, config expects a ResNet")
    if problems:
        raise ValueError(f"checkpoint does not match CLIP model "
                         f"'{cfg.name}': " + "; ".join(problems))


def convert_openai_checkpoint(path_or_sd) -> dict:
    """OpenAI-naming state dict -> the ViT tree (numpy)."""
    sd = (path_or_sd if isinstance(path_or_sd, dict)
          else _read_state_dict(path_or_sd))
    if not ("visual.conv1.weight" in sd and "visual.class_embedding" in sd):
        raise _resnet_unported()
    n_text = max(int(k.split(".")[2]) for k in sd
                 if k.startswith("transformer.resblocks.")) + 1
    text = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "blocks": [_block(sd, f"transformer.resblocks.{i}")
                   for i in range(n_text)],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
    }
    n_vis = max(int(k.split(".")[3]) for k in sd
                if k.startswith("visual.transformer.resblocks.")) + 1
    conv = _np(sd["visual.conv1.weight"])  # [width, 3, p, p]
    visual = {
        "conv": conv.reshape(conv.shape[0], -1).T,
        "class_emb": _np(sd["visual.class_embedding"]),
        "pos_emb": _np(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": [_block(sd, f"visual.transformer.resblocks.{i}")
                   for i in range(n_vis)],
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _np(sd["visual.proj"]),
    }
    return {"visual": visual, "text": text,
            "logit_scale": _np(sd["logit_scale"])}


def convert_hf_clip(sd_or_model) -> dict:
    """HuggingFace `transformers.CLIPModel` (ViT) state dict -> the tree
    (numpy); HF's separate q/k/v projections are merged into the qkv
    layout."""
    if hasattr(sd_or_model, "state_dict"):
        sd_or_model = sd_or_model.state_dict()
    sd = {k: _np(v) for k, v in sd_or_model.items()}

    def hf_ln(prefix):
        return {"g": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}

    def hf_block(prefix):
        a = prefix + ".self_attn."
        return {
            "ln_1": hf_ln(prefix + ".layer_norm1"),
            "attn": {
                "in_w": np.concatenate([sd[a + f"{n}_proj.weight"]
                                        for n in "qkv"], 0).T,
                "in_b": np.concatenate([sd[a + f"{n}_proj.bias"]
                                        for n in "qkv"], 0),
                "out_w": sd[a + "out_proj.weight"].T,
                "out_b": sd[a + "out_proj.bias"],
            },
            "ln_2": hf_ln(prefix + ".layer_norm2"),
            "mlp": {
                "fc_w": sd[prefix + ".mlp.fc1.weight"].T,
                "fc_b": sd[prefix + ".mlp.fc1.bias"],
                "proj_w": sd[prefix + ".mlp.fc2.weight"].T,
                "proj_b": sd[prefix + ".mlp.fc2.bias"],
            },
        }

    def n_layers(tower):
        pre = f"{tower}.encoder.layers."
        return max(int(k.split(".")[3]) for k in sd if k.startswith(pre)) + 1
    emb = "vision_model.embeddings."
    conv = sd[emb + "patch_embedding.weight"]
    visual = {
        "conv": conv.reshape(conv.shape[0], -1).T,
        "class_emb": sd[emb + "class_embedding"],
        "pos_emb": sd[emb + "position_embedding.weight"],
        "ln_pre": hf_ln("vision_model.pre_layrnorm"),
        "blocks": [hf_block(f"vision_model.encoder.layers.{i}")
                   for i in range(n_layers("vision_model"))],
        "ln_post": hf_ln("vision_model.post_layernorm"),
        "proj": sd["visual_projection.weight"].T,
    }
    text = {
        "token_embedding": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding":
            sd["text_model.embeddings.position_embedding.weight"],
        "blocks": [hf_block(f"text_model.encoder.layers.{i}")
                   for i in range(n_layers("text_model"))],
        "ln_final": hf_ln("text_model.final_layer_norm"),
        "text_projection": sd["text_projection.weight"].T,
    }
    return {"visual": visual, "text": text,
            "logit_scale": _np(sd.get("logit_scale", np.log(1 / 0.07)))}


def openai_state_dict(params) -> dict:
    """The inverse of `convert_openai_checkpoint`: a ViT tree (tensors or
    numpy) -> an OpenAI-naming state dict of CPU tensors, e.g. to write a
    checkpoint of random weights from `clip_init`."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().contiguous()
        return torch.as_tensor(np.ascontiguousarray(x))
    sd = {}

    def block(prefix, b):
        for ln in ("ln_1", "ln_2"):
            sd[f"{prefix}.{ln}.weight"] = t(b[ln]["g"])
            sd[f"{prefix}.{ln}.bias"] = t(b[ln]["b"])
        a, m = b["attn"], b["mlp"]
        sd[prefix + ".attn.in_proj_weight"] = t(a["in_w"]).t()
        sd[prefix + ".attn.in_proj_bias"] = t(a["in_b"])
        sd[prefix + ".attn.out_proj.weight"] = t(a["out_w"]).t()
        sd[prefix + ".attn.out_proj.bias"] = t(a["out_b"])
        sd[prefix + ".mlp.c_fc.weight"] = t(m["fc_w"]).t()
        sd[prefix + ".mlp.c_fc.bias"] = t(m["fc_b"])
        sd[prefix + ".mlp.c_proj.weight"] = t(m["proj_w"]).t()
        sd[prefix + ".mlp.c_proj.bias"] = t(m["proj_b"])
    v, tx = params["visual"], params["text"]
    conv = t(v["conv"])
    width, p = conv.shape[1], int(round((conv.shape[0] // 3) ** 0.5))
    sd["visual.conv1.weight"] = conv.t().reshape(width, 3, p, p)
    sd["visual.class_embedding"] = t(v["class_emb"])
    sd["visual.positional_embedding"] = t(v["pos_emb"])
    for name in ("ln_pre", "ln_post"):
        sd[f"visual.{name}.weight"] = t(v[name]["g"])
        sd[f"visual.{name}.bias"] = t(v[name]["b"])
    for i, b in enumerate(v["blocks"]):
        block(f"visual.transformer.resblocks.{i}", b)
    sd["visual.proj"] = t(v["proj"])
    sd["token_embedding.weight"] = t(tx["token_embedding"])
    sd["positional_embedding"] = t(tx["positional_embedding"])
    for i, b in enumerate(tx["blocks"]):
        block(f"transformer.resblocks.{i}", b)
    sd["ln_final.weight"] = t(tx["ln_final"]["g"])
    sd["ln_final.bias"] = t(tx["ln_final"]["b"])
    sd["text_projection"] = t(tx["text_projection"])
    sd["logit_scale"] = t(params["logit_scale"])
    return {k: x.contiguous() for k, x in sd.items()}
