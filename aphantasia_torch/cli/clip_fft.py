"""clip_fft: single-image CLIP-guided generation with the FFT or the DWT
parameterizer (counterpart of aphantasia_tpu.cli.clip_fft).

Same flags, defaults and post-parse rules as the JAX CLI, and the same
outputs: JPEG frames and config.txt in a run directory, an mp4 beside it,
and a `.pt` snapshot (the params list) with --save_pt.  Runs on the CUDA
device unless `--device cpu` is given; without a GPU it raises.

The training loop takes the JAX CLI's chunked path when `opt_step`
divides `steps`: `frames_per_dispatch` frame groups (one step, the frame's
render, `opt_step - 1` steps) a dispatch through
`step.build_train_loop_frames`, which on the card captures a group into a
CUDA graph after running it eagerly and replays it for the rest (one
graph per tower pattern under --dualmod), with the losses read and the
frames pulled once a dispatch.  Otherwise it runs the per-step loop.
`--profile DIR` writes a torch.profiler trace of the loop into DIR.

--dwt (the wavelet pyramid), --sync with an --in_img file (the LPIPS
term and its tone map), --aest (the LAION head), --dualmod N (ViT-B/16
every N-th step) and --clip_weights (an OpenAI, open_clip or HuggingFace
checkpoint) run as in the JAX CLI; every weight without a checkpoint is
random-init, loudly.  Every model of the list runs: the ViTs and the
ModifiedResNets (RN50 to RN50x16; no aesthetic head, as in JAX).
--mesh N|NxM|dcn runs the step over a data axis (and a model axis) of
ranks that `common.run_cli` starts, rank 0 writing the outputs; --fleet
runs the whole job on each host, as in JAX.  --spatial N (N > 1) shards
the canvas over N ranks a data rank (`parallel/spatial.py`: the spectrum's
columns, or with --dwt the finest pyramid levels' rows), composing with
--mesh N|NxM as the JAX CLI does (the cutout count rounded up to the data
axis; 'dcn' raises); every rank's chunked or per-step loop runs the
sharded step, and the `.pt` is gathered and saved unpadded, in the
reference layout.

    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --pallas
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" -m ViT-L/14
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" -m RN50x4
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --dwt
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --dualmod 4
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --mesh 2x2 \
        --device cpu
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" --spatial 2 \
        --mesh 2 --device cpu
    python -m aphantasia_torch.cli.clip_fft -t "a lighthouse" \
        -i photo.jpg --sync 0.4
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
    ClipWrapper, RunSetup, Tower, add_parallel_flags, apply_sample_budget,
    card_settings, dispatch_seconds, dualmod_steps, frame_writer,
    maybe_translate, parse_size, resolve_dtype, resolve_persp, round_samples,
    run_cli, setup_mesh, setup_spatial, spatial_canvas, spatial_count)
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.checkpoint import save_pt
from aphantasia_torch.io.media import frames_to_video, img_list, img_read
from aphantasia_torch.models.lpips import lpips_get
from aphantasia_torch.ops.losses import aesthetic_dims, aesthetic_get
from aphantasia_torch.ops.optim import build_optimizer
from aphantasia_torch.ops.resize import resize_bicubic
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.dwt import DWTParameterizer, resume_dwt
from aphantasia_torch.params.fft import FFTParameterizer, resume_fft
from aphantasia_torch.parallel.mesh import mesh_primary
from aphantasia_torch.profiling import span
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.step import (StepSettings, build_draw_fn, build_render,
                                   build_train_loop_frames, build_train_step,
                                   frames_per_dispatch)
from aphantasia_torch.utils import save_cfg, txt_clean

# the JAX CLI's list and ViT-L/14, which the JAX package's illustra and
# cppn CLIs offer
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
    parser.add_argument('--clip_weights', default=None, help='Path to CLIP checkpoint (OpenAI .pt or HF); random init if absent')
    parser.add_argument('--aest_weights', default=None, help='Path to LAION aesthetic head checkpoint')
    parser.add_argument('--lpips_weights', default=None, help='Path to VGG16+lin LPIPS checkpoint (--sync)')
    parser.add_argument('--precision', default='auto', choices=['auto', 'bf16', 'fp32'])
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--spatial', default=0, type=int,
                        help='Shard the canvas spatially over N ranks '
                             '(4K+ canvases; FFT, or --dwt)')
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


@dataclasses.dataclass
class RunResult:
    params: object                # final params: spectrum, or DWT list
    #                               (under --spatial gathered, unpadded)
    losses: list                  # one float per step
    # host wall time per step, synchronized: on the chunked path each step
    # of a dispatch gets its wall over its steps, and each tower pattern's
    # first frame group (its eager group and its graph's capture) its own
    step_seconds: list
    samples: int                  # cutouts per step after the budget
    out_name: str                 # run directory / file stem under out_dir
    video: str | None             # the video written, if any
    loop: object = None           # the chunked path's FrameLoop, if taken


def main(argv=None):
    run(get_args(argv))


def setup(a, spatial=None) -> RunSetup:
    """The run's parameterizer, towers, prompts and step pieces, and its
    output directory with config.txt (`a` is updated as the JAX CLI
    updates it: size, modsize, samples).  Under a spatial axis
    (`common.spatial_count`: --spatial above 1, or `spatial` given) the
    parameterizer is the sharded canvas, the params this rank's shard and
    `draw` draws the padded spectrum's noise."""
    spatial = spatial_count(a, spatial)
    device = resolve_device(a.device)
    dtype = resolve_dtype(a.precision, device)
    card_settings(device)
    gen = torch.Generator(device=device).manual_seed(a.seed)

    def seeded(seed, dev=device):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- parameterizer ----------------------------------------------------
    if a.dwt:
        gen_params, sz = resume_dwt(a.resume, a.size, a.wave, a.colors,
                                    generator=gen)
        if sz is not None:
            a.size = list(sz)
        par = DWTParameterizer(tuple(a.size), a.wave, 0.3, a.colors)
        gen_params = [p.to(device=device, dtype=torch.float32).contiguous()
                      for p in gen_params]
    else:
        gen_params, sz = resume_fft(a.resume, [1, 3, *a.size], a.decay,
                                    sd=0.07, generator=gen)
        if sz is not None:
            a.size = list(sz)
        par = FFTParameterizer(tuple(a.size), a.decay, a.colors)
        gen_params = gen_params.to(device=device,
                                   dtype=torch.float32).contiguous()

    # ---- CLIP model(s) ----------------------------------------------------
    clip1 = ClipWrapper(a.model, device, a.clip_weights,
                        generator=seeded(a.seed, "cpu"))
    a.modsize = clip1.modsize
    if a.verbose:
        print(' using model', a.model)
    clips = [clip1]
    if a.dualmod is not None:
        # the same weights path and seed as the first tower, as in JAX
        clips.append(ClipWrapper('ViT-B/16', device, a.clip_weights,
                                 generator=seeded(a.seed, "cpu")))
        print(' dual model every %d step' % a.dualmod)
    mesh = (setup_spatial(spatial, getattr(a, 'mesh', None), clips, a.verbose)
            if spatial else setup_mesh(getattr(a, 'mesh', None), clips,
                                       a.verbose))
    extra = (a.in_txt2 is not None) + (a.in_txt0 is not None)
    a.samples = apply_sample_budget(
        a.samples, a.model, a.dualmod, a.enforce, a.sync, a.transform, extra)

    # ---- aesthetic heads --------------------------------------------------
    aests = [None] * len(clips)
    if a.aest != 0 and aesthetic_dims(a.model):
        aests = [aesthetic_get(seeded(7 + i), c.name, a.aest_weights)
                 for i, c in enumerate(clips)]

    # ---- prompts ----------------------------------------------------------
    sign = 1.0 if a.invert else -1.0
    groups, out_name = [[] for _ in clips], []
    for txt, coeff, prefix in ((a.in_txt, sign, ''), (a.in_txt2, sign, ''),
                               (a.in_txt0, -sign, 'off-')):
        if txt is None:
            continue
        txt_en = maybe_translate(txt, a.translate, a.verbose)
        for clip, g in zip(clips, groups):
            embs, wts = clip.enc_text(txt_en)
            g.append((embs, wts, coeff))
        out_name.append(prefix + txt_clean(txt).lower()[:40])
    if a.in_txt is not None and a.verbose:
        print(' topic text:', a.in_txt)

    # ---- reference image / LPIPS sync -------------------------------------
    lpips_bundle = None
    if a.in_img is not None and os.path.isfile(a.in_img):
        img_np = img_read(a.in_img)
        # every tower encodes the same cutouts of the image
        start = gen.get_state()
        for i, (clip, g) in enumerate(zip(clips, groups)):
            img_gen = gen
            if i:
                img_gen = torch.Generator(device=device)
                img_gen.set_state(start)
            emb, img_t = clip.enc_image_sliced(img_np, a.samples, a.align,
                                               img_gen)
            g.append((emb, torch.full((emb.shape[0],), 1.0 / emb.shape[0],
                                      device=device), sign * a.weight_img))
        if a.sync > 0:
            img_in = resize_bicubic(img_t, [s // 2 for s in a.size])
            lpips_bundle = (lpips_get(seeded(9), a.lpips_weights), img_in)
        out_name.append(os.path.splitext(os.path.basename(a.in_img))[0]
                        .replace(' ', '_'))
    if not groups[0]:
        raise ValueError(' Loss not defined, check the inputs')
    if a.verbose:
        print(' samples:', a.samples)

    # ---- step functions ---------------------------------------------------
    draw_shape = None if a.dwt else tuple(gen_params.shape)
    if spatial:
        a.samples = round_samples(a.samples, mesh, a.verbose)
        par = spatial_canvas('dwt' if a.dwt else 'fft', a.size, mesh,
                             a.decay, a.colors, a.wave)
        gen_params = par.shard(gen_params)
        draw_shape = par.draw_shape
    sampler = CutoutSampler(tuple(a.size), a.samples, a.modsize, a.align,
                            a.macro, use_pallas=a.pallas)
    optimizer = build_optimizer(a.optimizer, a.lrate, a.steps, a.prog)
    settings = StepSettings(
        sim=a.sim or 'cossim', sharp=a.sharp if not a.dwt else 0.0,
        aest=a.aest, enforce=a.enforce, expand=a.expand, noise=a.noise,
        sync=a.sync, total_steps=max(a.steps // a.opt_step, 1),
        transform=a.transform, persp=resolve_persp(a.persp), clip_dtype=dtype)
    draw = build_draw_fn(sampler, settings, draw_shape)
    towers = [Tower(c.cfg, c.vision(dtype), ae, g)
              for c, ae, g in zip(clips, aests, groups)]

    # ---- output dirs ------------------------------------------------------
    out_name = '-'.join(out_name) or 'out'
    out_name += ('-%s' % a.model.replace('/', '').replace('-', '')
                 if a.dualmod is None else '-dm%d' % a.dualmod)
    tempdir = os.path.join(a.out_dir, out_name)
    if mesh_primary():
        os.makedirs(tempdir, exist_ok=True)
        save_cfg(a, tempdir, 'config.txt')
    return RunSetup(par, sampler, towers, lpips_bundle, a.dualmod, settings,
                    optimizer, draw, gen, gen_params, out_name, tempdir, mesh)


def run(a, on_step=None) -> RunResult:
    """The whole run; `on_step(i)`, if given, is called after step i (on
    the chunked path after the step's dispatch; a profiler's schedule
    hangs on it).  Under --mesh every rank runs it and this returns rank
    0's result (with the loop only when rank 0 ran in this process)."""
    return run_cli(a, _run, on_step)


def _run(a, on_step=None, spatial=None) -> RunResult:
    """The run on this rank; `spatial` as `setup` takes it."""
    from aphantasia_torch.parallel.spatial import (
        SpatialCanvas, build_spatial_render, build_spatial_train_loop_frames,
        build_spatial_train_step)
    su = setup(a, spatial)
    gen_params, out_name, tempdir = su.gen_params, su.out_name, su.tempdir
    step_args = (su.par, su.sampler, su.clip_cfg, su.settings, su.optimizer)
    sharded = isinstance(su.par, SpatialCanvas)

    # ---- training loop ----------------------------------------------------
    opt_state = su.optimizer.init(gen_params)
    prev_enc = torch.zeros((a.samples, su.clip_cfg.embed_dim),
                           device=su.gen.device)
    # empirical tone mapping, applied in the writer
    tone = None
    if a.sync > 0 and a.in_img is not None:
        tone = lambda im: ((im / 255.0) ** 1.3 * 255).astype(np.uint8)  # noqa: E731
    elif a.sharp != 0:
        tone = (lambda im: ((im / 255.0) ** (1 + a.sharp / 2.0) * 255)
                .astype(np.uint8))
    pbar = ProgressBar(a.steps // a.opt_step) if a.verbose else None
    losses, seconds = [], []
    # the JAX CLI's condition for its chunked loop; the random stream is
    # the per-step loop's (one draw a step, in step order) either way
    chunked = (a.opt_step > 0 and a.steps % a.opt_step == 0
               and a.steps >= a.opt_step)
    loop = None
    with frame_writer() as writer:
        if chunked:
            n_frames = a.steps // a.opt_step
            nf = frames_per_dispatch(tuple(a.size), n_frames)
            if sharded:
                loop = build_spatial_train_loop_frames(
                    *step_args, a.opt_step, nf, contrast=a.contrast,
                    dual=su.dual)
            else:
                loop = build_train_loop_frames(
                    *step_args, a.opt_step, nf, contrast=a.contrast,
                    dual=su.dual, mesh=su.mesh)
            for c in range(n_frames // nf):
                t0 = time.perf_counter()
                gen_params, opt_state, prev_enc, frames, dl = loop(
                    gen_params, opt_state, prev_enc, *su.loop_args(),
                    lambda gstep: su.draw(su.gen), c * nf)
                writer.save_batch([os.path.join(tempdir, '%04d.jpg' % f)
                                   for f in range(c * nf, (c + 1) * nf)],
                                  frames, tone)
                with span("loss_read"):
                    losses += dl.tolist()     # the dispatch's one wait
                seconds += dispatch_seconds(time.perf_counter() - t0,
                                            loop.first_runs, nf, a.opt_step)
                for i in range(c * nf * a.opt_step, len(losses)):
                    if pbar is not None and i % a.opt_step == 0:
                        pbar.upd()
                    if on_step is not None:
                        on_step(i)
        else:
            cfgs = [t.cfg for t in su.towers]
            if sharded:
                steps = [build_spatial_train_step(
                    su.par, su.sampler, cfg, su.settings, su.optimizer)
                    for cfg in cfgs]
                render = build_spatial_render(su.par)
            else:
                steps = [build_train_step(su.par, su.sampler, cfg,
                                          su.settings, su.optimizer, su.mesh)
                         for cfg in cfgs]
                render = build_render(su.par)
            dm_nums = (dualmod_steps(a.steps, a.dualmod) if a.dualmod
                       else set())
            for i in range(a.steps):
                t0 = time.perf_counter()
                tower = int(i in dm_nums)
                gen_params, opt_state, prev_enc, loss = steps[tower](
                    gen_params, opt_state, prev_enc, *su.consts(tower),
                    su.draw(su.gen), i // a.opt_step)
                with span("loss_read"):
                    losses.append(loss.item())    # waits for the step's work
                seconds.append(time.perf_counter() - t0)
                if i % a.opt_step == 0:
                    frame = render(gen_params, contrast=a.contrast).cpu().numpy()
                    writer.save(os.path.join(tempdir, '%04d.jpg' % (i // a.opt_step)),
                                frame, tone)
                    if pbar is not None:
                        pbar.upd()
                if on_step is not None:
                    on_step(i)

    # ---- assembly (rank 0 of a mesh) ----------------------------------------
    if sharded:
        # every rank gathers; the canonical layout, pads dropped
        gen_params = su.par.full(gen_params)
    video = None
    if mesh_primary():
        video = frames_to_video(tempdir,
                                os.path.join(a.out_dir, f'{out_name}.mp4'))
        frames = img_list(tempdir)
        if frames:
            shutil.copy(frames[-1], os.path.join(
                a.out_dir, '%s-%d.jpg' % (out_name, a.steps)))
        if a.save_pt:
            # params LIST, as the reference saves it
            save_pt('%s.pt' % os.path.join(a.out_dir, out_name),
                    list(gen_params) if a.dwt else [gen_params])
    return RunResult(gen_params, losses, seconds, a.samples, out_name, video,
                     loop)


if __name__ == '__main__':
    main()
