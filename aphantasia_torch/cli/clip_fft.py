"""clip_fft: single-image CLIP-guided generation with the FFT
parameterizer (counterpart of aphantasia_tpu.cli.clip_fft).

Same flags, defaults and post-parse rules as the JAX CLI, and the same
outputs: JPEG frames and config.txt in a run directory, an mp4 beside it,
and a `.pt` snapshot with --save_pt.  Runs on the CUDA device unless
`--device cpu` is given; without a GPU it raises.

The training loop takes the JAX CLI's chunked path when `opt_step`
divides `steps`: `frames_per_dispatch` frame groups (one step, the frame's
render, `opt_step - 1` steps) a dispatch through
`step.build_train_loop_frames`, which on the card captures the first
group into a CUDA graph after running it eagerly and replays it for the
rest, with the losses read and the frames pulled once a dispatch.
Otherwise it runs the per-step loop.  `--profile DIR` writes a
torch.profiler trace of the loop into DIR.

Flags whose features are not ported yet raise: --dwt, --sync, --aest,
--dualmod, --spatial, --mesh, --fleet and models other than ViT-B/32,
ViT-B/16 and ViT-L/14 (ROADMAP.md lists them).

    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --pallas
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" -m ViT-L/14
    APHANTASIA_WIN_CUTOUT=1 APHANTASIA_PALLAS_LN=1 \
        python -m aphantasia_torch.cli.clip_fft -t "a lighthouse"
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --persp exact
    APHANTASIA_PALLAS_SHIFT=1 python -m aphantasia_torch.cli.clip_fft \
        -t "a lighthouse" -tf elastic
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time

import numpy as np
import torch

from aphantasia_torch.cli.common import (
    ClipWrapper, add_parallel_flags, apply_sample_budget, maybe_translate,
    parse_size, resolve_dtype, resolve_persp)
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.checkpoint import save_pt
from aphantasia_torch.io.media import (AsyncFrameWriter, frames_to_video,
                                       img_list, img_read)
from aphantasia_torch.models.clip.model import PORTED_MODELS
from aphantasia_torch.ops.optim import build_optimizer
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer, resume_fft
from aphantasia_torch.profiling import trace
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.step import (StepSettings, build_draw_fn, build_render,
                                   build_train_loop_frames, build_train_step,
                                   frames_per_dispatch)
from aphantasia_torch.utils import save_cfg, txt_clean

# the JAX CLI's list and ViT-L/14, which the JAX package's illustra and
# cppn CLIs offer and this port's towers run
CLIP_MODELS = ["ViT-B/16", "ViT-B/32", "ViT-L/14", "RN101", "RN50x16",
               "RN50x4", "RN50"]


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-t',  '--in_txt',  default=None, help='input text')
    parser.add_argument('-t2', '--in_txt2', default=None, help='input text - style')
    parser.add_argument('-t0', '--in_txt0', default=None, help='input text to subtract')
    parser.add_argument('-i',  '--in_img',  default=None, help='input image')
    parser.add_argument('-wi', '--weight_img', default=0.5, type=float, help='weight for images')
    parser.add_argument('--out_dir', default='_out')
    parser.add_argument('-s',  '--size',    default='1280-720', help='Output resolution')
    parser.add_argument('-r',  '--resume',  default=None, help='Path to saved FFT snapshots, to resume from')
    parser.add_argument('-ops', '--opt_step', default=1, type=int, help='How many optimizing steps per save step')
    parser.add_argument('-tr', '--translate', action='store_true', help='Translate text with Google Translate')
    parser.add_argument('--save_pt', action='store_true', help='Save FFT snapshots for further use')
    parser.add_argument('-v',  '--verbose',    dest='verbose', action='store_true')
    parser.add_argument('-nv', '--no-verbose', dest='verbose', action='store_false')
    parser.set_defaults(verbose=True)
    # training
    parser.add_argument('-m',  '--model',   default='ViT-B/32', choices=CLIP_MODELS, help='Select CLIP model to use')
    parser.add_argument('--steps',   default=200, type=int, help='Total iterations')
    parser.add_argument('--samples', default=200, type=int, help='Samples to evaluate')
    parser.add_argument('-lr', '--lrate',   default=0.05, type=float, help='Learning rate')
    parser.add_argument('-p',  '--prog',    action='store_true', help='Enable progressive lrate growth (up to double a.lrate)')
    parser.add_argument('-dm', '--dualmod', default=None, type=int, help='Every this step use another CLIP ViT model')
    # wavelet
    parser.add_argument('--dwt',     action='store_true', help='Use DWT instead of FFT')
    parser.add_argument('-w',  '--wave',    default='coif2', help='wavelets: db[1..], coif[1..], haar, dmey')
    # tweaks
    parser.add_argument('-a',  '--align',   default='uniform', choices=['central', 'uniform', 'overscan', 'overmax'], help='Sampling distribution')
    parser.add_argument('-tf', '--transform', default='fast', choices=['none', 'fast', 'custom', 'elastic', 'lucent', 'openai'], help='augmenting transforms')
    parser.add_argument('-opt', '--optimizer', default='adam_custom', choices=['adam', 'adamw', 'adam_custom', 'adamw_custom'], help='Optimizer')
    parser.add_argument('--contrast', default=1.1, type=float)
    parser.add_argument('--colors',  default=1.8, type=float)
    parser.add_argument('--decay',   default=1.5, type=float)
    parser.add_argument('-sh', '--sharp',   default=0., type=float)
    parser.add_argument('-mm', '--macro',   default=0.4, type=float, help='Endorse macro forms 0..1 ')
    parser.add_argument('--aest',    default=0., type=float, help='Enhance aesthetics')
    parser.add_argument('-e',  '--enforce', default=0, type=float, help='Enforce details')
    parser.add_argument('-x',  '--expand',  default=0, type=float, help='Boosts diversity')
    parser.add_argument('-n',  '--noise',   default=0, type=float, help='Add noise to suppress accumulation')
    parser.add_argument('-c',  '--sync',    default=0, type=float, help='Sync output to input image')
    parser.add_argument('--invert',  action='store_true', help='Invert criteria')
    parser.add_argument('--sim',     default='mix', help='Similarity function (dot/angular/spherical/mixed; None = cossim)')
    parser.add_argument('--clip_weights', default=None, help='Path to CLIP checkpoint (not ported yet); random init if absent')
    parser.add_argument('--aest_weights', default=None, help='Path to LAION aesthetic head checkpoint (not ported yet)')
    parser.add_argument('--lpips_weights', default=None, help='Path to LPIPS checkpoint (not ported yet)')
    parser.add_argument('--precision', default='auto', choices=['auto', 'bf16', 'fp32'])
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--spatial', default=0, type=int,
                        help='not ported: spatially sharded canvases')
    add_parallel_flags(parser)
    a = parser.parse_args(argv)
    if a.dualmod is not None and a.dualmod < 1:
        parser.error('--dualmod must be a positive step interval')

    if a.size is not None:
        a.size = parse_size(a.size)
    if (a.in_img is not None and a.sync != 0) or a.resume is not None:
        a.align = 'overscan'
    if a.dualmod is not None:
        a.model = 'ViT-B/32'
        a.sim = 'cossim'
    return a


def check_ported(a) -> None:
    """Raise for every flag whose feature the port does not have yet."""
    unported = [name for name, on in (
        ('--dwt', a.dwt), ('--sync', a.sync != 0), ('--aest', a.aest != 0),
        ('--dualmod', a.dualmod is not None), ('--spatial', a.spatial > 1),
        ('--mesh', a.mesh not in (None, '0', '1')), ('--fleet', a.fleet),
        ('--model ' + a.model, a.model not in PORTED_MODELS)) if on]
    if unported:
        raise NotImplementedError(
            f"not ported to aphantasia_torch yet: {', '.join(unported)}; "
            "see ROADMAP.md")


@dataclasses.dataclass
class RunResult:
    params: torch.Tensor          # final spectrum params
    losses: list                  # one float per step
    # host wall time per step, synchronized: on the chunked path each step
    # of a dispatch gets its wall over its steps, and the first frame
    # group (the eager group and the graph's capture) its own
    step_seconds: list
    samples: int                  # cutouts per step after the budget
    out_name: str                 # run directory / file stem under out_dir
    video: str | None             # the video written, if any


@dataclasses.dataclass
class RunSetup:
    """What a run builds before its training loop."""
    par: FFTParameterizer
    sampler: CutoutSampler
    clip_cfg: object              # the tower's CLIPConfig
    clip_vis: dict                # its vision weights in the compute dtype
    prompts: list                 # (embs [K,D], wts [K], coeff) groups
    settings: StepSettings
    optimizer: object
    draw: object                  # draw(generator) -> StepDraws
    gen: torch.Generator          # the run's generator, after the init
    gen_params: torch.Tensor      # the start spectrum
    out_name: str
    tempdir: str                  # the run directory (frames, config.txt)


def main(argv=None):
    run(get_args(argv))


def setup(a) -> RunSetup:
    """The run's parameterizer, tower, prompts and step pieces, and its
    output directory with config.txt (`a` is updated as the JAX CLI
    updates it: size, modsize, samples)."""
    check_ported(a)
    device = resolve_device(a.device)
    dtype = resolve_dtype(a.precision, device)
    if device.type == "cuda":
        # float32 products stay float32 (TF32 would keep ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(a.seed)
    cpu_gen = torch.Generator().manual_seed(a.seed)

    # ---- parameterizer ----------------------------------------------------
    gen_params, sz = resume_fft(a.resume, [1, 3, *a.size], a.decay, sd=0.07,
                                generator=gen)
    if sz is not None:
        a.size = list(sz)
    par = FFTParameterizer(tuple(a.size), a.decay, a.colors)
    gen_params = gen_params.to(device=device, dtype=torch.float32).contiguous()

    # ---- CLIP model -------------------------------------------------------
    clip1 = ClipWrapper(a.model, device, a.clip_weights, generator=cpu_gen)
    a.modsize = clip1.modsize
    if a.verbose:
        print(' using model', a.model)
    extra = (a.in_txt2 is not None) + (a.in_txt0 is not None)
    a.samples = apply_sample_budget(
        a.samples, a.model, a.dualmod, a.enforce, a.sync, a.transform, extra)

    # ---- prompts ----------------------------------------------------------
    sign = 1.0 if a.invert else -1.0
    prompts, out_name = [], []
    for txt, coeff, prefix in ((a.in_txt, sign, ''), (a.in_txt2, sign, ''),
                               (a.in_txt0, -sign, 'off-')):
        if txt is None:
            continue
        embs, wts = clip1.enc_text(maybe_translate(txt, a.translate, a.verbose))
        prompts.append((embs, wts, coeff))
        out_name.append(prefix + txt_clean(txt).lower()[:40])
    if a.in_txt is not None and a.verbose:
        print(' topic text:', a.in_txt)
    if a.in_img is not None and os.path.isfile(a.in_img):
        emb, _ = clip1.enc_image_sliced(img_read(a.in_img), a.samples,
                                        a.align, gen)
        prompts.append((emb, torch.full((emb.shape[0],), 1.0 / emb.shape[0],
                                        device=device), sign * a.weight_img))
        out_name.append(os.path.splitext(os.path.basename(a.in_img))[0]
                        .replace(' ', '_'))
    if not prompts:
        raise ValueError(' Loss not defined, check the inputs')
    if a.verbose:
        print(' samples:', a.samples)

    # ---- step functions ---------------------------------------------------
    sampler = CutoutSampler(tuple(a.size), a.samples, a.modsize, a.align,
                            a.macro, use_pallas=a.pallas)
    optimizer = build_optimizer(a.optimizer, a.lrate, a.steps, a.prog)
    settings = StepSettings(
        sim=a.sim or 'cossim', sharp=a.sharp, aest=a.aest, enforce=a.enforce,
        expand=a.expand, noise=a.noise, sync=a.sync, transform=a.transform,
        persp=resolve_persp(a.persp), clip_dtype=dtype)
    draw = build_draw_fn(sampler, settings, tuple(gen_params.shape))
    clip_vis = clip1.vision(dtype)

    # ---- output dirs ------------------------------------------------------
    out_name = '-'.join(out_name) or 'out'
    out_name += '-%s' % a.model.replace('/', '').replace('-', '')
    tempdir = os.path.join(a.out_dir, out_name)
    os.makedirs(tempdir, exist_ok=True)
    save_cfg(a, tempdir, 'config.txt')
    return RunSetup(par, sampler, clip1.cfg, clip_vis, prompts, settings,
                    optimizer, draw, gen, gen_params, out_name, tempdir)


def run(a, on_step=None) -> RunResult:
    """The whole run; `on_step(i)`, if given, is called after step i (on
    the chunked path after the step's dispatch; a profiler's schedule
    hangs on it)."""
    su = setup(a)
    gen_params, out_name, tempdir = su.gen_params, su.out_name, su.tempdir
    step_args = (su.par, su.sampler, su.clip_cfg, su.settings, su.optimizer)

    # ---- training loop ----------------------------------------------------
    opt_state = su.optimizer.init(gen_params)
    prev_enc = torch.zeros((a.samples, su.clip_cfg.embed_dim),
                           device=gen_params.device)
    tone = None
    if a.sharp != 0:
        tone = (lambda im: ((im / 255.0) ** (1 + a.sharp / 2.0) * 255)
                .astype(np.uint8))
    pbar = ProgressBar(a.steps // a.opt_step) if a.verbose else None
    losses, seconds = [], []
    # the JAX CLI's condition for its chunked loop; the random stream is
    # the per-step loop's (one draw a step, in step order) either way
    chunked = (a.opt_step > 0 and a.steps % a.opt_step == 0
               and a.steps >= a.opt_step)
    with trace(a.profile), AsyncFrameWriter() as writer:
        if chunked:
            n_frames = a.steps // a.opt_step
            nf = frames_per_dispatch(tuple(a.size), n_frames)
            loop = build_train_loop_frames(*step_args, a.opt_step, nf,
                                           contrast=a.contrast)
            for c in range(n_frames // nf):
                t0 = time.perf_counter()
                gen_params, opt_state, prev_enc, frames, dl = loop(
                    gen_params, opt_state, prev_enc, su.clip_vis, su.prompts,
                    lambda gstep: su.draw(su.gen), c * nf)
                writer.save_batch([os.path.join(tempdir, '%04d.jpg' % f)
                                   for f in range(c * nf, (c + 1) * nf)],
                                  frames, tone)
                losses += dl.tolist()     # the dispatch's one wait
                wall = time.perf_counter() - t0
                n = nf * a.opt_step
                if c == 0:
                    first = loop.group.first_seconds
                    seconds += [first / a.opt_step] * a.opt_step
                    wall, n = wall - first, n - a.opt_step
                seconds += [wall / n] * n
                for i in range(c * nf * a.opt_step, len(losses)):
                    if pbar is not None and i % a.opt_step == 0:
                        pbar.upd()
                    if on_step is not None:
                        on_step(i)
        else:
            step = build_train_step(*step_args)
            render = build_render(su.par)
            for i in range(a.steps):
                t0 = time.perf_counter()
                gen_params, opt_state, prev_enc, loss = step(
                    gen_params, opt_state, prev_enc, su.clip_vis, su.prompts,
                    su.draw(su.gen), i // a.opt_step)
                losses.append(loss.item())        # waits for the step's work
                seconds.append(time.perf_counter() - t0)
                if i % a.opt_step == 0:
                    frame = render(gen_params, contrast=a.contrast).cpu().numpy()
                    writer.save(os.path.join(tempdir, '%04d.jpg' % (i // a.opt_step)),
                                frame, tone)
                    if pbar is not None:
                        pbar.upd()
                if on_step is not None:
                    on_step(i)

    # ---- assembly ---------------------------------------------------------
    video = frames_to_video(tempdir, os.path.join(a.out_dir, f'{out_name}.mp4'))
    frames = img_list(tempdir)
    if frames:
        shutil.copy(frames[-1],
                    os.path.join(a.out_dir, '%s-%d.jpg' % (out_name, a.steps)))
    if a.save_pt:
        # params LIST, as the reference saves it
        save_pt('%s.pt' % os.path.join(a.out_dir, out_name), [gen_params])
    return RunResult(gen_params, losses, seconds, a.samples, out_name, video)


if __name__ == '__main__':
    main()
