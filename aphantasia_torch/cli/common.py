"""Shared CLI plumbing (counterpart of aphantasia_tpu.cli.common): prompt
encoding, the sample-budget cascade, precision and device selection."""
from __future__ import annotations

import os

import numpy as np
import torch

from aphantasia_torch.models.clip.model import (
    XMEM, cast_weights, encode_image, encode_text, input_resolution,
    load_clip)
from aphantasia_torch.models.clip.tokenizer import tokenize
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.color import clip_normalize


def parse_size(size_str):
    """'1280-720' -> [720, 1280]."""
    size = [int(s) for s in size_str.split("-")][::-1]
    if len(size) == 1:
        size = size * 2
    return size


def resolve_dtype(name: str, device: torch.device):
    """`auto` is bf16 on the card (as bf16 on the TPU) and float32 on the
    CPU."""
    auto = torch.bfloat16 if device.type == "cuda" else torch.float32
    return {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
            "fp32": torch.float32, "float32": torch.float32,
            "auto": auto}[name]


class ClipWrapper:
    """A loaded CLIP model on a device, with its text/image encoders.
    `params` stays float32 (the text tower and reference images encode in
    float32, as in the JAX package); `vision(dtype)` gives the tree with
    its matmul weights cast once for the training step."""

    def __init__(self, name: str, device: torch.device,
                 weights: str | None = None,
                 generator: torch.Generator | None = None):
        self.name = name
        self.device = device
        params, self.cfg = load_clip(name, weights, generator=generator)
        self.params = _to(params, device)
        self.modsize = input_resolution(name)

    def vision(self, dtype):
        return {"visual": cast_weights(self.params["visual"], dtype)}

    @torch.no_grad()
    def enc_text(self, txt: str):
        """Prompt syntax `txt :w | txt2 :w2` -> (embs [K,D], weights [K])."""
        embs, wts = [], []
        for subtxt in txt.split("|"):
            if ":" in subtxt:
                subtxt, wt = subtxt.split(":")
                wt = float(wt)
            else:
                wt = 1.0
            toks = tokenize(subtxt, context_length=self.cfg.context_length)
            toks = torch.as_tensor(toks, device=self.device)
            embs.append(encode_text(self.params, self.cfg, toks)[0])
            wts.append(wt)
        return (torch.stack(embs),
                torch.tensor(wts, dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def enc_image_sliced(self, img_np, samples, align,
                         generator: torch.Generator):
        """Encode a reference image through the cutout sampler."""
        img = torch.as_tensor(np.asarray(img_np) / 255.0, dtype=torch.float32,
                              device=self.device)
        img = img.permute(2, 0, 1)[None][:, :3]
        sampler = CutoutSampler(tuple(img.shape[-2:]), samples, self.modsize,
                                align)
        cuts = sampler.cut(img, sampler.sample_boxes(generator))
        return encode_image(self.params, self.cfg, clip_normalize(cuts)), img


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def apply_sample_budget(samples: int, model: str, dualmod=None,
                        enforce: float = 0, sync: float = 0,
                        transform: str = "fast",
                        extra_prompts: int = 0) -> int:
    """The constant-memory sample multiplier cascade."""
    if model in XMEM:
        samples = int(samples * XMEM[model])
    if dualmod is not None:
        samples = int(samples * 0.23)
    if enforce != 0:
        samples = int(samples * 0.5)
    if sync > 0:
        samples = int(samples * 0.5)
    if transform in ("elastic", "custom", "fast"):
        samples = int(samples * 0.95)
    for _ in range(extra_prompts):
        samples = int(samples * 0.75)
    return max(samples, 1)


def dualmod_steps(steps: int, dualmod: int) -> set:
    """The step indices handled by the second tower: every `dualmod`-th
    step from `dualmod` on."""
    return set(list(range(steps))[dualmod::dualmod])


def add_parallel_flags(parser):
    """The JAX CLIs' shared flags.  --pallas (the CUDA cutout kernel),
    --persp and --profile are ported; the others are accepted so that
    they can raise a clear error."""
    parser.add_argument('--mesh', default=None,
                        help='not ported: multi-device meshes (ROADMAP.md)')
    parser.add_argument('--persp', default=None,
                        choices=['affine', 'mixed', 'exact'],
                        help="fast-pipeline perspective: 'affine' (default; "
                             "its least-squares affine fit), 'mixed' (the "
                             "exact homography through the CUDA kernel, "
                             "rotation as an affine warp) or 'exact' (both "
                             "through the kernel).  Default: affine "
                             "(equivalent env var: "
                             "APHANTASIA_EXACT_PERSP=mixed|1)")
    parser.add_argument('--profile', default=None,
                        help='write a torch.profiler trace of the training '
                             'loop into this directory')
    parser.add_argument('--pallas', action='store_true',
                        help='Use the hand-written CUDA cutout kernel')
    parser.add_argument('--fleet', default=None,
                        help='not ported: multi-host fleets (ROADMAP.md)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a GPU) or 'cpu'")
    return parser


def resolve_persp(flag) -> str:
    """The `fast` pipeline's perspective mode, with the JAX CLIs'
    precedence: the --persp flag wins; without it,
    APHANTASIA_EXACT_PERSP=mixed selects 'mixed', any other non-empty
    value 'exact', and unset or empty 'affine'."""
    if flag is not None:
        return flag
    mode = os.environ.get("APHANTASIA_EXACT_PERSP")
    if not mode:
        return "affine"
    return "mixed" if mode == "mixed" else "exact"


def maybe_translate(texts, enabled: bool, verbose=True):
    """--translate needs googletrans; exit loudly when it is unavailable."""
    if not enabled:
        return texts
    try:
        from googletrans import Translator
    except ImportError:
        raise SystemExit(
            " --translate requires the googletrans package, which is not "
            "installed. Drop --translate and pass English prompts.") from None
    out = Translator().translate(texts, dest="en").text
    if verbose:
        print(" translated to:", out)
    return out
