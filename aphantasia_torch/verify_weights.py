"""One-command weight verification through the port's own loaders
(counterpart of aphantasia_tpu.verify_weights):

    python -m aphantasia_torch.verify_weights [checkpoint dir] [--device cpu]

For every frozen tower (CLIP, the LAION aesthetic head, LPIPS,
Depth-Anything-V2, the VQGAN decoder) it resolves a checkpoint (the
conventional file names under the directory, else the APHANTASIA_*_PT
variable, else MISSING), converts it through the port's converter
(`models/clip/convert.py`, `ops/losses.aesthetic_load`,
`models/lpips.lpips_get`, `models/depth_anything/convert.convert_hf_dav2`,
`models/vqgan.convert_taming`) and runs a forward on the device.  A torch
reference runs where torch alone can execute the checkpoint: CLIP
TorchScript archives (cosine of the embeddings >= 0.98) and the aesthetic
linear head (max |diff| < 1e-4); the other rows report "converted".  With
no checkpoints every row is MISSING.

Exit code: 1 if a checkpoint that is present fails, else 0 (a missing
checkpoint is reported, not failed).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

CLIP_FILES = {
    "ViT-B-32.pt": "ViT-B/32", "ViT-B-16.pt": "ViT-B/16",
    "ViT-L-14.pt": "ViT-L/14", "RN50.pt": "RN50", "RN101.pt": "RN101",
    "RN50x4.pt": "RN50x4", "RN50x16.pt": "RN50x16", "RN50x64.pt": "RN50x64",
}

PROMPTS = ["a photograph of a red fox in snow",
           "an oil painting of a lighthouse at dusk"]


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _find(dirpath, names=(), substrs=(), exts=(), want_dir=False):
    if not dirpath or not os.path.isdir(dirpath):
        return None
    entries = sorted(os.listdir(dirpath))
    for n in names:
        if n in entries:
            return os.path.join(dirpath, n)
    for e in entries:
        p = os.path.join(dirpath, e)
        if want_dir != os.path.isdir(p):
            continue
        low = e.lower()
        if any(s in low for s in substrs) and (
                want_dir or any(low.endswith(x) for x in exts)):
            return p
    return None


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@torch.no_grad()
def _verify_clip(model, path, device):
    from aphantasia_torch.models.clip.model import (encode_image,
                                                    encode_text, load_clip)
    from aphantasia_torch.models.clip.tokenizer import tokenize
    params, cfg = load_clip(model, path)
    params = _to(params, device)
    toks = np.asarray(tokenize(PROMPTS, context_length=cfg.context_length))
    imgs = np.random.RandomState(0).rand(
        2, 3, cfg.image_resolution, cfg.image_resolution).astype(np.float32)
    ours_t = encode_text(params, cfg, torch.as_tensor(toks, device=device))
    ours_i = encode_image(params, cfg, torch.as_tensor(imgs, device=device))
    ours_t, ours_i = ours_t.cpu().numpy(), ours_i.cpu().numpy()
    if not (np.isfinite(ours_t).all() and np.isfinite(ours_i).all()):
        return "FAILED", "non-finite encodings"
    try:
        ref = torch.jit.load(path, map_location="cpu").float().eval()
        ref_t = ref.encode_text(torch.as_tensor(toks)).numpy()
        ref_i = ref.encode_image(torch.as_tensor(imgs)).numpy()
    except Exception:
        return "converted", "forward finite; no runnable torch reference"
    c = min(_cos(ours_t, ref_t), _cos(ours_i, ref_i))
    return (("verified", f"cosine {c:.4f} >= 0.98 (vs torch.jit)")
            if c >= 0.98 else
            ("FAILED", f"cosine {c:.4f} < 0.98 (vs torch.jit)"))


@torch.no_grad()
def _verify_aesthetic(path, device):
    from aphantasia_torch.ops.losses import aesthetic_apply, aesthetic_load
    params = aesthetic_load(path, device)
    emb = np.random.RandomState(1).randn(4, params["w"].shape[0]).astype(
        np.float32)
    ours = aesthetic_apply(params, torch.as_tensor(emb, device=device))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.split(".")[-1]: v.double().numpy() for k, v in sd.items()}
    ref = emb @ sd["weight"].T + sd["bias"]
    err = float(np.abs(ours.cpu().numpy().ravel() - ref.ravel()).max())
    return (("verified", f"max |diff| {err:.2e}") if err < 1e-4
            else ("FAILED", f"max |diff| {err:.2e}"))


@torch.no_grad()
def _verify_lpips(path, device):
    from aphantasia_torch.models.lpips import lpips_apply, lpips_get
    params = lpips_get(torch.Generator(device=device).manual_seed(0), path)
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.rand(1, 3, 64, 64).astype(np.float32),
                        device=device)
    y = torch.as_tensor(rng.rand(1, 3, 64, 64).astype(np.float32),
                        device=device)
    d = float(lpips_apply(params, x, y)[0])
    d0 = float(lpips_apply(params, x, x)[0])
    if not np.isfinite(d) or abs(d0) > 1e-6 or d <= 0:
        return "FAILED", f"d(x,y)={d:.4f} d(x,x)={d0:.2e}"
    return "verified", f"d(x,y)={d:.4f}, d(x,x)=0"


@torch.no_grad()
def _verify_dav2(path, device):
    from aphantasia_torch.models.depth_anything import InferDepthAny
    from aphantasia_torch.models.depth_anything.convert import convert_hf_dav2
    params = convert_hf_dav2(path)
    width = int(params["backbone"]["pos_emb"].shape[-1])
    modtype = {384: "s", 768: "b", 1024: "l"}.get(width, "s")
    infer = InferDepthAny(modtype, params=params, device=device)
    img = np.random.RandomState(3).rand(1, 3, 14 * 6, 14 * 8).astype(
        np.float32)
    ours = infer(torch.as_tensor(img, device=device))
    if not bool(torch.isfinite(ours).all()):
        return "FAILED", "non-finite depth"
    return "converted", "depth finite; no runnable torch reference"


@torch.no_grad()
def _verify_vqgan(path, device):
    from aphantasia_torch.models.vqgan import (VQGAN_CONFIGS, convert_taming,
                                               vqgan_decode)
    cfg = VQGAN_CONFIGS["gumbel_f8_8192" if "gumbel" in path.lower()
                        else "imagenet_f16_16384"]
    params = convert_taming(path, cfg, device)
    img = vqgan_decode(params, cfg, torch.zeros((1, cfg.z_channels, 8, 8),
                                                device=device))
    if not bool(torch.isfinite(img).all()):
        return "FAILED", "non-finite decode"
    return "converted", f"decode finite ({cfg.name})"


def collect_rows(ckpt_dir, device="cpu"):
    """Resolve, convert and verify every tower: (rows, any_failed) with
    rows = [(component, path or '-', status, detail), ...]."""
    os.environ.setdefault("APHANTASIA_QUIET", "1")
    from aphantasia_torch.weights import env_weights
    device = torch.device(device)

    jobs = []
    if ckpt_dir:
        for fname, model in CLIP_FILES.items():
            p = os.path.join(ckpt_dir, fname)
            if os.path.isfile(p):
                jobs.append((f"clip {model}", p,
                             lambda p=p, m=model: _verify_clip(m, p, device)))
    if not jobs:
        p = env_weights("clip")
        p = p if p and os.path.exists(p) else None
        jobs.append(("clip ViT-B/32", p,
                     lambda p=p: _verify_clip("ViT-B/32", p, device)))

    for comp, find_kw, envk, fn in (
            ("aesthetic", dict(substrs=("sa_0_4", "aesthetic"),
                               exts=(".pth", ".pt")), "aesthetic",
             _verify_aesthetic),
            ("lpips", dict(substrs=("lpips",), exts=(".pt", ".npz")),
             "lpips", _verify_lpips),
            ("depth-anything-v2", dict(substrs=("depth", "dav2"),
                                       want_dir=True), "dav2", _verify_dav2),
            ("vqgan", dict(names=("last.ckpt",), substrs=("vqgan",),
                           exts=(".ckpt", ".pt")), "vqgan", _verify_vqgan)):
        p = _find(ckpt_dir, **find_kw) or env_weights(envk)
        if p and not os.path.exists(p):
            p = None
        jobs.append((comp, p, lambda p=p, fn=fn: fn(p, device)))

    rows, any_failed = [], False
    for comp, path, fn in jobs:
        if path is None:
            rows.append((comp, "-", "MISSING", "no checkpoint found"))
            continue
        try:
            status, detail = fn()
        except Exception as e:
            status, detail = "FAILED", f"{type(e).__name__}: {e}"
        any_failed |= status == "FAILED"
        rows.append((comp, path, status, detail))
    return rows, any_failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from aphantasia_torch.device import resolve_device
    device = resolve_device(args.device)
    rows, any_failed = collect_rows(args.ckpt_dir, device)

    w0 = max(len(r[0]) for r in rows) + 2
    w2 = max(len(r[2]) for r in rows) + 2
    print(f"\n weight verification ({args.ckpt_dir or 'env vars only'}, "
          f"{device}):\n")
    for comp, path, status, detail in rows:
        print(f"  {comp:<{w0}} {status:<{w2}} {detail}")
        if path != "-":
            print(f"  {'':<{w0}} {'':<{w2}} {path}")
    n_ok = sum(r[2] in ("verified", "converted") for r in rows)
    print(f"\n  {n_ok}/{len(rows)} present, "
          f"{sum(r[2] == 'verified' for r in rows)} torch-verified, "
          f"{sum(r[2] == 'MISSING' for r in rows)} missing, "
          f"{sum(r[2] == 'FAILED' for r in rows)} failed\n")
    return 1 if any_failed else 0


if __name__ == "__main__":
    sys.exit(main())
