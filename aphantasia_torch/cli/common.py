"""Shared CLI plumbing (counterpart of aphantasia_tpu.cli.common): prompt
encoding, the sample-budget cascade, precision and device selection, the
--fleet and --mesh launch, and the spectrum crossfade of illustra and
interpol."""
from __future__ import annotations

import argparse
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
from aphantasia_torch.profiling import span, trace
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
    its matmul weights cast once for the training step.  Loading (the
    checkpoint's read and conversion, or the random draw, and the copy to
    the device) is a span "setup.clip", each prompt's encoding a span
    "setup.text"."""

    def __init__(self, name: str, device: torch.device,
                 weights: str | None = None,
                 generator: torch.Generator | None = None):
        self.name = name
        self.device = device
        with span("setup.clip"):
            params, self.cfg = load_clip(name, weights, generator=generator)
            self.params = _to(params, device)
        self.modsize = input_resolution(name)

    def vision(self, dtype):
        return {"visual": cast_weights(self.params["visual"], dtype)}

    @torch.no_grad()
    def enc_text(self, txt: str):
        """Prompt syntax `txt :w | txt2 :w2` -> (embs [K,D], weights [K])."""
        with span("setup.text"):
            embs, wts = [], []
            for subtxt in txt.split("|"):
                if ":" in subtxt:
                    subtxt, wt = subtxt.split(":")
                    wt = float(wt)
                else:
                    wt = 1.0
                toks = tokenize(subtxt,
                                context_length=self.cfg.context_length)
                toks = torch.as_tensor(toks, device=self.device)
                embs.append(encode_text(self.params, self.cfg, toks)[0])
                wts.append(wt)
            return (torch.stack(embs),
                    torch.tensor(wts, dtype=torch.float32,
                                 device=self.device))

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
    mesh: object = None           # this rank's parallel.mesh.Mesh, or None

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


FLEET_HELP = ("multi-host fleet coordinates 'RANK/WORLD[@COORDINATOR:PORT]' "
              "(or the APHANTASIA_FLEET variable); with a coordinator, a "
              "gloo group over it coordinates the hosts. Scene-level "
              "fan-out: illustra shards scenes, interpol snapshot pairs; "
              "the other CLIs run their whole job on each host")


def add_parallel_flags(parser):
    """The JAX CLIs' shared flags: --mesh, --persp, --profile, --pallas
    (the CUDA cutout kernel), --fleet, and the port's --device."""
    parser.add_argument('--mesh', default=None,
                        help="'N' (a data axis of N ranks), 'NxM' (data x "
                             "model, the CLIP blocks tensor-parallel over "
                             "M) or 'dcn' (the data axis over every rank of "
                             "every host of a --fleet with a coordinator); "
                             "one rank per GPU over NCCL, or with --device "
                             "cpu CPU processes over gloo")
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
                        help='write a torch.profiler trace of the run '
                             '(set-up and loop, with the program\'s spans) '
                             'into this directory')
    parser.add_argument('--pallas', action='store_true',
                        help='Use the hand-written CUDA cutout kernel')
    parser.add_argument('--fleet', default=None, help=FLEET_HELP)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a GPU) or 'cpu'")
    return parser


def _mesh_dims(spec):
    """(kind, ranks): ('dcn', None), or ('grid', (data, model)); None for
    the dense path ('1', '0' or no spec)."""
    if not spec or str(spec) in ("0", "1"):
        return None
    s = str(spec).lower()
    try:
        if s == "dcn":
            return "dcn", None
        dp, tp = (int(v) for v in s.split("x")) if "x" in s else (int(s), 1)
        if dp < 1 or tp < 1:
            raise ValueError("axis sizes must be positive")
    except ValueError as e:
        raise SystemExit(
            f"--mesh expects 'N' (data-parallel), 'NxM' (data x model) or "
            f"'dcn' (multi-host data axis), got {spec!r}: {e}") from None
    return "grid", (dp, tp)


def mesh_plan(spec, device, spatial: int = 0):
    """How the ranks of a --mesh spec and a --spatial count start
    (`parallel.mesh.Plan`), or None for the dense path (no spec and
    --spatial 0 or 1).  'N' and 'NxM' put every rank on this host, times
    the spatial count; on the card that needs as many GPUs, else it
    raises.  --spatial with 'dcn' raises, as in JAX."""
    from aphantasia_torch.parallel.dcn import plan_dcn
    from aphantasia_torch.parallel.mesh import Plan, free_port, local_devices
    dims = _mesh_dims(spec)
    spatial = spatial if spatial and spatial > 1 else 1
    if dims is None and spatial == 1:
        return None
    kind = torch.device(device).type
    if dims is not None and dims[0] == "dcn":
        if spatial > 1:
            raise ValueError("--spatial composes with --mesh N or NxM, not "
                             "with 'dcn' (as in the JAX package)")
        return plan_dcn(None, kind)
    n = spatial * (1 if dims is None else dims[1][0] * dims[1][1])
    have = local_devices(kind) if kind == "cuda" else n
    if n > have:
        raise SystemExit(f"--mesh {spec} --spatial {spatial} needs {n} "
                         f"devices, have {have}")
    return Plan(n, f"127.0.0.1:{free_port()}", kind)


def run_cli(a, body, *args):
    """body(a, *args) under the run's --fleet, --mesh and --spatial: the
    fleet's coordinates first (`init_fleet`), then with a mesh its ranks
    (`parallel.mesh.launch`: one rank runs here, more are spawned, one
    per GPU or CPU process); returns rank 0's result.  Every rank runs
    the whole CLI; rank 0 writes the files and prints.  Under --profile
    each rank's body (set-up and loop) runs inside `profiling.trace`."""
    from aphantasia_torch.parallel.mesh import launch
    from aphantasia_torch.parallel.multihost import init_fleet
    init_fleet(getattr(a, 'fleet', None))
    plan = mesh_plan(getattr(a, 'mesh', None), a.device,
                     getattr(a, 'spatial', 0))
    if plan is None:
        with trace(getattr(a, 'profile', None)):
            return body(a, *args)
    if plan.world > 1 and any(x is not None for x in args):
        raise ValueError("a callback does not cross to spawned mesh ranks")
    return launch(_cli_rank, (body, a) + args, plan)


def _cli_rank(body, a, *args):
    """One mesh rank of a CLI: its own GPU, and rank 0's result."""
    from aphantasia_torch.parallel.mesh import mesh_primary
    if torch.device(a.device).type == "cuda":
        a = argparse.Namespace(**vars(a))
        a.device = f"cuda:{torch.cuda.current_device()}"
    with trace(getattr(a, 'profile', None)):
        res = body(a, *args)
    return res if mesh_primary() else None


def setup_mesh(spec, clip_wrappers=(), verbose=True):
    """The mesh of this rank from a --mesh spec (None for the dense path),
    on the group its launch made; with a model axis every ClipWrapper's
    params are replaced by this rank's tensor-parallel shard.  The port's
    attention kernel stays on under a mesh (each rank runs its own
    program); the JAX package turns its fused attention off."""
    from aphantasia_torch.parallel.dcn import make_mesh_dcn
    from aphantasia_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                shard_clip_params)
    dims = _mesh_dims(spec)
    if dims is None:
        return None
    if dims[0] == "dcn":
        mesh = make_mesh_dcn()
    elif str(spec).lower().count("x"):
        mesh = make_mesh_2d(*dims[1])
    else:
        mesh = make_mesh(dims[1][0])
    if mesh.shape.get("model", 1) > 1:
        for w in clip_wrappers:
            if w is not None:
                w.params = shard_clip_params(w.params, mesh, w.cfg)
    if verbose:
        print(f" mesh: {dict(mesh.shape)}")
    return mesh


def spatial_count(a, spatial=None):
    """The run's spatial axis: `spatial` when given (one rank on the card
    is `spatial=1`), else --spatial when above 1; None for the dense
    path."""
    if spatial:
        return spatial
    return a.spatial if getattr(a, 'spatial', 0) > 1 else None


def setup_spatial(spatial: int, spec, clip_wrappers=(), verbose=True):
    """The ('data'[, 'model'], 'spatial') mesh of this rank from --spatial
    and --mesh (`parallel.mesh.make_mesh_spatial`), on the group its
    launch made; with a model axis every ClipWrapper's params are
    replaced by this rank's tensor-parallel shard, as `setup_mesh`
    does."""
    from aphantasia_torch.parallel.mesh import (make_mesh_spatial,
                                                shard_clip_params)
    mesh = make_mesh_spatial(spatial, spec)
    if mesh.size("model") > 1:
        for w in clip_wrappers:
            if w is not None:
                w.params = shard_clip_params(w.params, mesh, w.cfg)
    if verbose:
        print(f" spatial mesh: {dict(mesh.shape)}")
    return mesh


def round_samples(samples: int, mesh, verbose=True) -> int:
    """The cutout count rounded up to a multiple of the data axis, as the
    JAX CLIs round it under --spatial."""
    dp = mesh.size("data")
    if samples % dp:
        samples += dp - samples % dp
        if verbose:
            print(f' samples rounded up to {samples} (data mesh {dp})')
    return samples


def spatial_canvas(kind: str, size, mesh, decay=1.5, colors=1.8,
                   wave='coif2', fixcontrast=False):
    """The sharded parameterizer of a run: 'fft', 'dwt' or 'rgb'."""
    from aphantasia_torch.parallel.spatial import SpatialFFT, SpatialRGB
    from aphantasia_torch.parallel.spatial_dwt import SpatialDWT
    if kind == 'dwt':
        return SpatialDWT(tuple(size), wave, 0.3, colors, mesh)
    if kind == 'rgb':
        return SpatialRGB(tuple(size), colors, mesh, fixcontrast)
    return SpatialFFT(tuple(size), decay, colors, mesh)


class NullWriter:
    """The frame writer of a mesh rank that writes nothing (rank 0
    writes)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def save(self, *args, **kwargs):
        pass

    def save_batch(self, *args, **kwargs):
        pass

    def flush(self):
        pass


def frame_writer():
    """The run's frame writer: an AsyncFrameWriter on rank 0 of a mesh (or
    without one), a NullWriter on the other ranks."""
    from aphantasia_torch.parallel.mesh import mesh_primary
    return AsyncFrameWriter() if mesh_primary() else NullWriter()


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
              verbose: bool = True, pairs=None) -> int:
    """`vsteps` frames from each snapshot towards the next (the last
    towards the first), `%05d.jpg` in `tempdir`, `frames_per_dispatch`
    frames a batched render; returns the frames written.  `pairs` (a
    fleet's share) limits it to the transitions from those snapshots."""
    rloop = build_shift_render_loop(par, contrast)
    nf = frames_per_dispatch(tuple(par.size), vsteps)
    pairs = range(len(ptfiles)) if pairs is None else pairs
    pbar = ProgressBar(vsteps * len(pairs)) if verbose else None
    written = 0
    with AsyncFrameWriter() as fw:
        for px in pairs:
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
