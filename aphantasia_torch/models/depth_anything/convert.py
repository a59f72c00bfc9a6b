"""HF `AutoModelForDepthEstimation` (Depth-Anything-V2) checkpoints -> the
port's tree (counterpart of aphantasia_tpu.models.depth_anything.convert).

Maps the transformers `DepthAnythingForDepthEstimation` state-dict names
(backbone.* Dinov2, neck.* reassembly and fusion, head.* output
convolutions) onto models/depth_anything/{dinov2,dpt}.py: linear weights
transposed to [in, out] and the q, k, v projections merged, as in the
JAX tree; convolutions stay OIHW and the transposed convolutions stay
[in, out, kh, kw], torch's own layouts.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().contiguous()
    return torch.as_tensor(np.array(x, np.float32))


def _load_hf_dir(path):
    """The state dict of an HF model directory (model.safetensors or
    pytorch_model.bin)."""
    st = os.path.join(path, "model.safetensors")
    if os.path.isfile(st):
        from safetensors.torch import load_file
        return load_file(st)
    binp = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(binp):
        return torch.load(binp, map_location="cpu")
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin "
                            f"in {path}")


def convert_hf_dav2(path_or_sd):
    """A checkpoint (an HF directory, a `torch.save`d state dict or module,
    a state dict of tensors or arrays, or a module) -> the port's DA-V2
    tree of float32 CPU tensors."""
    if isinstance(path_or_sd, str):
        if os.path.isdir(path_or_sd):
            sd = _load_hf_dir(path_or_sd)
        else:
            sd = torch.load(path_or_sd, map_location="cpu",
                            weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
    elif hasattr(path_or_sd, "state_dict"):
        sd = path_or_sd.state_dict()
    else:
        sd = path_or_sd
    sd = {k: _t(v) for k, v in sd.items()}

    def ln(prefix):
        return {"g": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}

    n_blocks = max(int(k.split(".")[3]) for k in sd
                   if k.startswith("backbone.encoder.layer.")) + 1
    blocks = []
    for i in range(n_blocks):
        p = f"backbone.encoder.layer.{i}"
        a = p + ".attention.attention."
        blocks.append({
            "ln_1": ln(p + ".norm1"),
            "attn": {
                "qkv_w": torch.cat([sd[a + n + ".weight"]
                                    for n in ("query", "key", "value")],
                                   0).t().contiguous(),
                "qkv_b": torch.cat([sd[a + n + ".bias"]
                                    for n in ("query", "key", "value")], 0),
                "proj_w": sd[p + ".attention.output.dense.weight"].t()
                .contiguous(),
                "proj_b": sd[p + ".attention.output.dense.bias"],
            },
            "ls1": sd[p + ".layer_scale1.lambda1"],
            "ln_2": ln(p + ".norm2"),
            "mlp": {
                "fc1_w": sd[p + ".mlp.fc1.weight"].t().contiguous(),
                "fc1_b": sd[p + ".mlp.fc1.bias"],
                "fc2_w": sd[p + ".mlp.fc2.weight"].t().contiguous(),
                "fc2_b": sd[p + ".mlp.fc2.bias"],
            },
            "ls2": sd[p + ".layer_scale2.lambda1"],
        })
    pw = sd["backbone.embeddings.patch_embeddings.projection.weight"]
    backbone = {
        "patch_w": pw.reshape(pw.shape[0], -1).t().contiguous(),
        "patch_b": sd["backbone.embeddings.patch_embeddings.projection.bias"],
        "cls_token": sd["backbone.embeddings.cls_token"][0, 0],
        "pos_emb": sd["backbone.embeddings.position_embeddings"][0],
        "blocks": blocks,
    }
    # the final LayerNorm, applied to every tapped layer
    if "backbone.layernorm.weight" in sd:
        backbone["final_ln"] = ln("backbone.layernorm")

    fusion = []
    for i in range(4):
        p = f"neck.fusion_stage.layers.{i}"

        def rcu(j):
            r = f"{p}.residual_layer{j}."
            return {"conv1_w": sd[r + "convolution1.weight"],
                    "conv1_b": sd[r + "convolution1.bias"],
                    "conv2_w": sd[r + "convolution2.weight"],
                    "conv2_b": sd[r + "convolution2.bias"]}
        fusion.append({"rcu1": rcu(1), "rcu2": rcu(2),
                       "out_w": sd[p + ".projection.weight"],
                       "out_b": sd[p + ".projection.bias"]})
    rs = "neck.reassemble_stage.layers."
    head = {
        "proj_w": [sd[f"{rs}{i}.projection.weight"][:, :, 0, 0].t()
                   .contiguous() for i in range(4)],
        "proj_b": [sd[f"{rs}{i}.projection.bias"] for i in range(4)],
        "up4_w": sd[rs + "0.resize.weight"], "up4_b": sd[rs + "0.resize.bias"],
        "up2_w": sd[rs + "1.resize.weight"], "up2_b": sd[rs + "1.resize.bias"],
        "down_w": sd[rs + "3.resize.weight"],
        "down_b": sd[rs + "3.resize.bias"],
        "scratch_w": [sd[f"neck.convs.{i}.weight"] for i in range(4)],
        # HF orders the fusion layers coarsest first; the tree finest first
        "fusion": fusion[::-1],
        "out1_w": sd["head.conv1.weight"], "out1_b": sd["head.conv1.bias"],
        "out2_w": sd["head.conv2.weight"], "out2_b": sd["head.conv2.bias"],
        "out3_w": sd["head.conv3.weight"], "out3_b": sd["head.conv3.bias"],
    }
    return {"backbone": backbone, "head": head}
