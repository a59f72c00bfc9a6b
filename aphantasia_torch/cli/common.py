"""Shared CLI plumbing (counterpart of aphantasia_tpu.cli.common): prompt
encoding, the sample-budget cascade, precision and device selection, and
the spectrum crossfade of illustra and interpol."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from aphantasia_torch.io.checkpoint import load_pt
from aphantasia_torch.io.media import AsyncFrameWriter
from aphantasia_torch.models.clip.model import (
    XMEM, cast_weights, encode_image, encode_text, input_resolution,
    load_clip)
from aphantasia_torch.models.clip.tokenizer import tokenize
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.color import clip_normalize
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.step import (StepSettings, build_shift_render_loop,
                                   frames_per_dispatch)


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


def card_settings(device: torch.device) -> None:
    """On the card: float32 products stay float32 (TF32 would keep ~3
    digits), and cuDNN (the ResNet, LPIPS and DWT convolutions) picks
    deterministic algorithms, the same ones eager and captured."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


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


@dataclasses.dataclass
class Tower:
    """One CLIP tower's constants of the train step."""
    cfg: object                   # the tower's CLIPConfig
    vis: dict                     # its vision weights in the compute dtype
    aest: dict | None             # its aesthetic head (--aest)
    prompts: list                 # (embs [K,D], wts [K], coeff) groups


@dataclasses.dataclass
class RunSetup:
    """What a run builds before its training loop."""
    par: object                   # the parameterizer
    sampler: CutoutSampler
    towers: list                  # [Tower]; the second under --dualmod
    lpips_bundle: tuple | None    # (LPIPS params, half-size target), --sync
    dm_every: int | None          # --dualmod
    settings: StepSettings
    optimizer: object
    draw: object                  # draw(generator) -> StepDraws
    gen: torch.Generator          # the run's generator, after the init
    gen_params: object            # the start params (a tensor or a list)
    out_name: str
    tempdir: str                  # the run directory (frames, config.txt)

    @property
    def clip_cfg(self):
        return self.towers[0].cfg

    @property
    def dual(self):
        """`build_train_loop_frames`'s `dual`, or None."""
        if self.dm_every is None:
            return None
        return self.towers[1].cfg, self.dm_every

    def consts(self, tower: int = 0) -> tuple:
        """(clip_params, aest_params, lpips_bundle, prompts) of a tower:
        the train step's arguments after prev_enc."""
        t = self.towers[tower]
        return t.vis, t.aest, self.lpips_bundle, t.prompts

    def loop_args(self) -> tuple:
        """A frame loop's arguments after prev_enc and before the draws."""
        extra = () if self.dm_every is None else (
            self.towers[1].vis, self.towers[1].aest, self.towers[1].prompts)
        return self.consts(0) + extra


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


def dispatch_seconds(wall: float, firsts: dict, nf: int, n: int) -> list:
    """A chunked dispatch's wall split over its `nf` frame groups of `n`
    steps, one entry a step: each group that ran its pattern's eager
    first run and capture (`firsts`, group -> seconds) its own, the other
    groups the rest in equal shares."""
    rest = (wall - sum(firsts.values())) / max(nf - len(firsts), 1)
    return [firsts.get(j, rest) / n for j in range(nf) for _ in range(n)]


def build_prompt_groups(groups):
    """[(embs, wts, coeff)] -> a tuple of (embs, wts, coeff), the Nones
    skipped: copies of the embeddings and weights, and each coefficient a
    0-d float32 tensor on their device.  A frame step adopts its first
    frame's groups as its buffers and copies later frames' into them, so
    the groups must not alias a scene's encodings."""
    out = []
    for g in groups:
        if g is None:
            continue
        embs, wts, coeff = g
        out.append((embs.clone(), wts.clone(),
                    torch.full((), float(coeff), dtype=torch.float32,
                               device=embs.device)))
    return tuple(out)


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


def check_ported(a) -> None:
    """Raise for every flag given whose feature the port does not have
    yet: --spatial, --mesh and --fleet (those a CLI has)."""
    unported = [name for name, on in (
        ('--spatial', getattr(a, 'spatial', 0) > 1),
        ('--mesh', getattr(a, 'mesh', None) not in (None, '0', '1')),
        ('--fleet', getattr(a, 'fleet', None))) if on]
    if unported:
        raise NotImplementedError(
            f"not ported to aphantasia_torch yet: {', '.join(unported)}; "
            "see ROADMAP.md A.10")


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


def read_pt(path, device) -> torch.Tensor:
    """A spectrum snapshot (a bare tensor, or the first of a list) as a
    float32 tensor on `device`."""
    obj = load_pt(path)
    if isinstance(obj, list):
        obj = obj[0]
    return torch.as_tensor(np.asarray(obj, np.float32), device=device)


def crossfade(par, contrast, ptfiles, vsteps: int, tempdir: str, device,
              verbose: bool = True) -> int:
    """`vsteps` frames from each snapshot towards the next (the last
    towards the first), `%05d.jpg` in `tempdir`, `frames_per_dispatch`
    frames a batched render; returns the frames written."""
    rloop = build_shift_render_loop(par, contrast)
    nf = frames_per_dispatch(tuple(par.size), vsteps)
    pbar = ProgressBar(vsteps * len(ptfiles)) if verbose else None
    written = 0
    with AsyncFrameWriter() as fw:
        for px in range(len(ptfiles)):
            p1 = read_pt(ptfiles[px], device)
            diff = read_pt(ptfiles[(px + 1) % len(ptfiles)], device) - p1
            for c in range(0, vsteps, nf):
                xs = torch.arange(c, c + nf, dtype=torch.float32) / vsteps
                fw.save_batch([os.path.join(tempdir,
                                            '%05d.jpg' % (px * vsteps + c + j))
                               for j in range(nf)], rloop(p1, diff, xs))
                written += nf
                for _ in range(nf if pbar is not None else 0):
                    pbar.upd()
    return written
