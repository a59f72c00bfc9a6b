"""OpenAI CLIP's towers (clip/model.py of github.com/openai/CLIP: the
VisionTransformer and the text Transformer), plain, from an OpenAI-layout
state dict, and the hashing fallback tokenizer that stands in for the
BPE merges table the repository does not hold."""
from __future__ import annotations

import hashlib
import html
import re

import torch
import torch.nn.functional as F

from .precision import REFERENCE

SOT, EOT = 49406, 49407


def tokenize(text: str, context: int = 77) -> torch.Tensor:
    """[1, context] ids: start, one hashed id a whitespace word
    (sha256 mod 49405, plus 1), end, zeros."""
    text = html.unescape(html.unescape(text)).strip()
    text = re.sub(r"\s+", " ", text).strip().lower()
    ids = [int(hashlib.sha256(w.encode()).hexdigest(), 16) % (SOT - 1) + 1
           for w in text.split(" ") if w]
    ids = [SOT] + ids + [EOT]
    if len(ids) > context:
        ids = ids[:context]
        ids[-1] = EOT
    out = torch.zeros((1, context), dtype=torch.long)
    out[0, :len(ids)] = torch.tensor(ids)
    return out


def load_state_dict(path: str, device) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().to(device) for k, v in sd.items()}


def _ln(x, sd, prefix):
    return F.layer_norm(x, x.shape[-1:], sd[prefix + ".weight"],
                        sd[prefix + ".bias"], 1e-5)


def _linear(x, w, b, q):
    return q(x) @ q(w).t() + b


def _block(x, sd, prefix, heads, q, causal=False):
    n, t, d = x.shape
    hd = d // heads
    h = _ln(x, sd, prefix + ".ln_1")
    qkv = _linear(h, sd[prefix + ".attn.in_proj_weight"],
                  sd[prefix + ".attn.in_proj_bias"], q)
    qq, kk, vv = qkv.view(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = (q(qq) @ q(kk).transpose(-1, -2)) * hd ** -0.5
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    o = q(torch.softmax(s, dim=-1)) @ q(vv)
    o = o.transpose(1, 2).reshape(n, t, d)
    x = x + _linear(o, sd[prefix + ".attn.out_proj.weight"],
                    sd[prefix + ".attn.out_proj.bias"], q)
    h = _ln(x, sd, prefix + ".ln_2")
    h = _linear(h, sd[prefix + ".mlp.c_fc.weight"],
                sd[prefix + ".mlp.c_fc.bias"], q)
    h = h * torch.sigmoid(1.702 * h)
    return x + _linear(h, sd[prefix + ".mlp.c_proj.weight"],
                       sd[prefix + ".mlp.c_proj.bias"], q)


def encode_image(sd, vision: dict, x, prec=REFERENCE):
    """x [N, 3, r, r], CLIP-normalised -> [N, embed]; the products in the
    precision's `low` rounding (the program's tower is bf16)."""
    q = prec.lo
    p = vision["patch_size"]
    x = F.conv2d(q(x), q(sd["visual.conv1.weight"]), stride=p)
    n, d = x.shape[:2]
    x = x.reshape(n, d, -1).transpose(1, 2)
    cls = sd["visual.class_embedding"].expand(n, 1, d)
    x = torch.cat([cls, x], 1) + sd["visual.positional_embedding"]
    x = _ln(x, sd, "visual.ln_pre")
    for i in range(vision["layers"]):
        x = _block(x, sd, f"visual.transformer.resblocks.{i}",
                   vision["heads"], q)
    x = _ln(x[:, 0], sd, "visual.ln_post")
    return q(x) @ q(sd["visual.proj"])


def encode_text(sd, text: dict, prompt: str, prec=REFERENCE):
    """One prompt -> [1, embed]; the products in the precision's `full`
    rounding (the program's text tower is float32)."""
    q = prec.hi
    toks = tokenize(prompt, text["context_length"]).to(
        sd["token_embedding.weight"].device)
    x = sd["token_embedding.weight"][toks] + sd["positional_embedding"]
    for i in range(text["layers"]):
        x = _block(x, sd, f"transformer.resblocks.{i}", text["heads"], q,
                   causal=True)
    x = _ln(x, sd, "ln_final")
    x = x[torch.arange(x.shape[0]), toks.argmax(-1)]
    return q(x) @ q(sd["text_projection"])


def prompt_embeddings(sd, text: dict, prompt: str, prec=REFERENCE):
    """A prompt line `a :w | b` -> (embs [K, D], weights [K]): each part
    encoded alone, its weight after ':' (1 without)."""
    embs, wts = [], []
    for part in prompt.split("|"):
        wt = 1.0
        if ":" in part:
            part, w = part.split(":")
            wt = float(w)
        embs.append(encode_text(sd, text, part, prec)[0])
        wts.append(wt)
    return torch.stack(embs), torch.tensor(wts, device=embs[0].device)
