"""illustra: one scene per text line, and a crossfade video through them
(counterpart of aphantasia_tpu.cli.illustra).

Same flags, defaults and outputs as the JAX CLI.  Each scene trains the
FFT spectrum against its line's prompts (and the style line's, and an
image prompt's); a scene starts from the last scene's spectrum rescaled to
`keep / (max - min)`, with the optimizer state carried over, or from a
fresh init under --separate.  Each scene writes its frames into
`<out_dir>/<name>/`, its last frame, an mp4 and the spectrum as a bare
tensor `.pt`; without --separate the crossfade between consecutive
snapshots (`step.build_shift_render_loop`) goes into `<out_dir>/_final/`
and `<out_dir>/<text file name>.mp4`.  Ctrl-C assembles the scenes
finished so far.  Runs on the CUDA device unless `--device cpu` is
given; without a GPU it raises.

Training takes the chunked path when `save_step` divides `steps`
(`build_train_loop_frames` with the global step as the loss's step index):
on the card the run's first frame group is captured into a CUDA graph and
every later group replays it, the later scenes included, which copy their
start spectrum, the carried optimizer state, their prompt embeddings and
a zeroed `prev_enc` into the graph's buffers.  Otherwise it runs the
per-step loop.  Each scene draws from its own generator, seeded from
(--seed, the scene's number), so its random stream does not depend on
the chunking.  --mesh N|NxM|dcn runs the steps over mesh ranks
(`common.run_cli`), rank 0 writing.  --fleet R/W (or APHANTASIA_FLEET)
renders scenes R, R+W, ... on this host, each fresh (keep-chaining is
sequential), and rank 0 assembles the piece once every scene's snapshot
is in the shared out_dir, waiting up to APHANTASIA_FLEET_WAIT seconds.
--spatial N (N > 1) trains every scene on the spectrum sharded over N
ranks a data rank (`parallel/spatial.py`), with --mesh N|NxM as in JAX:
the keep-chaining rescale takes the range over every rank, and each
scene's `.pt` is gathered and saved unpadded, in the reference layout.

    python -m aphantasia_torch.cli.illustra -t scenes.txt --pallas
    python -m aphantasia_torch.cli.illustra -t scenes.txt -m RN50x64
    python -m aphantasia_torch.cli.illustra -t scenes.txt --dualmod 4
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
    ClipWrapper, add_parallel_flags, card_settings, crossfade,
    dispatch_seconds, dualmod_steps, frame_writer, maybe_translate,
    parse_size, resolve_dtype, resolve_persp, round_samples, run_cli,
    setup_mesh, setup_spatial, spatial_canvas, spatial_count)
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.checkpoint import save_pt
from aphantasia_torch.io.media import (basename, file_list,
                                       frames_to_video, img_list, img_read)
from aphantasia_torch.models.clip.model import XMEM
from aphantasia_torch.ops.losses import aesthetic_dims, aesthetic_get
from aphantasia_torch.ops.optim import build_optimizer
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer, resume_fft
from aphantasia_torch.parallel.mesh import mesh_primary
from aphantasia_torch.parallel.multihost import fleet_info, shard_scenes
from aphantasia_torch.profiling import span
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.step import (StepSettings, build_draw_fn, build_render,
                                   build_train_loop_frames, build_train_step,
                                   frames_per_dispatch)
from aphantasia_torch.utils import pick_, read_text, save_cfg, txt_clean

CLIP_MODELS = ['ViT-B/16', 'ViT-B/32', 'ViT-L/14', 'ViT-L/14@336px',
               'RN50', 'RN50x4', 'RN50x16', 'RN50x64', 'RN101']


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-s',  '--size',    default='1280-720', help='Output resolution')
    parser.add_argument('-t',  '--in_txt',  default=None, help='input text or file - main topic')
    parser.add_argument('-t2', '--in_txt2', default=None, help='input text or file - style')
    parser.add_argument('-im', '--in_img',  default=None, help='input image or directory with images')
    parser.add_argument('-r',  '--resume',  default=None, help='Resume from saved params')
    parser.add_argument('--out_dir', default='_out/fft')
    parser.add_argument('--save_step', default=1, type=int, help='Save every this step')
    parser.add_argument('-tr', '--translate', action='store_true')
    parser.add_argument('-v',  '--verbose',    dest='verbose', action='store_true')
    parser.add_argument('-nv', '--no-verbose', dest='verbose', action='store_false')
    parser.set_defaults(verbose=True)
    # training
    parser.add_argument('-m',  '--model',   default='ViT-B/32', choices=CLIP_MODELS)
    parser.add_argument('--steps',   default=150, type=int, help='Iterations per input')
    parser.add_argument('--samples', default=200, type=int)
    parser.add_argument('-lr', '--lrate',   default=0.05, type=float)
    parser.add_argument('-dm', '--dualmod', default=None, type=int)
    # tweaks
    parser.add_argument('-opt', '--optimr', default='adam', choices=['adam', 'adamw'])
    parser.add_argument('-a',  '--align',   default='uniform', choices=['central', 'uniform', 'overscan', 'overmax'])
    parser.add_argument('-tf', '--transform', default='fast', choices=['none', 'custom', 'fast', 'elastic', 'lucent', 'openai'])
    parser.add_argument('--aest',    default=1., type=float)
    parser.add_argument('--contrast', default=1.1, type=float)
    parser.add_argument('--colors',  default=1.8, type=float)
    parser.add_argument('-d',  '--decay',   default=1.5, type=float)
    parser.add_argument('-sh', '--sharp',   default=0, type=float)
    parser.add_argument('-mc', '--macro',   default=0.4, type=float)
    parser.add_argument('-e',  '--enforce', default=0, type=float)
    parser.add_argument('-n',  '--noise',   default=0, type=float)
    parser.add_argument('--sim',     default='mix')
    parser.add_argument('--loop',    action='store_true', help='Loop inputs')
    parser.add_argument('--save_pt', action='store_true')
    # multi input
    parser.add_argument('-l',  '--length',  default=None, type=int, help='Override total length in sec')
    parser.add_argument('--lsteps',  default=25, type=int, help='Frames per step')
    parser.add_argument('--fps',     default=25, type=int)
    parser.add_argument('--keep',    default=1.5, type=float, help='Accumulate imagery: 0 random, 1+ ~prev')
    parser.add_argument('--separate', action='store_true', help='process inputs separately')
    parser.add_argument('--clip_weights', default=None)
    parser.add_argument('--aest_weights', default=None)
    parser.add_argument('--precision', default='auto', choices=['auto', 'bf16', 'fp32'])
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--spatial', default=0, type=int,
                        help='Shard the FFT canvas spatially over N ranks')
    add_parallel_flags(parser)
    a = parser.parse_args(argv)
    if a.dualmod is not None and a.dualmod < 1:
        parser.error('--dualmod must be a positive step interval')

    a.size = parse_size(a.size)
    if not a.separate:
        a.save_pt = True
    if a.dualmod is not None:
        a.model = 'ViT-B/32'
        a.sim = 'cossim'
    return a


def sample_budget(samples: int, model: str, dualmod=None,
                  transform: str = 'fast', enforce: float = 0) -> int:
    """illustra's cascade (JAX cli/illustra.py:122-134): one multiplier
    accumulated, then applied once: XMEM, 0.23 under --dualmod, 1.05 for
    the `none` transform, 0.95, and 0.5 under --enforce."""
    bx = 1.0
    if model in XMEM:
        bx *= XMEM[model]
    if dualmod is not None:
        bx *= 0.23
    if transform == 'none':
        bx *= 1.05
    bx *= 0.95
    if enforce != 0:
        bx *= 0.5
    return max(int(bx * samples), 1)


def keep_chain(params: torch.Tensor, keep: float, spar=None) -> torch.Tensor:
    """The next scene's start: the last spectrum times keep / (max - min)
    (JAX cli/illustra.py:297-298); on a sharded canvas `spar` the range
    over every rank."""
    if spar is not None:
        from aphantasia_torch.parallel.spatial import global_range
        return keep * params / global_range(params, spar)
    return keep * params / (params.max() - params.min())


def scene_generator(seed: int, num: int, stream: int, device) -> torch.Generator:
    """The generator of scene `num`'s stream (0: the step draws, 1: the
    spectrum init, 2: image prompt `num`'s cutouts), seeded from (seed,
    stream, num) alone."""
    state = np.random.SeedSequence([seed, stream, num]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class SceneLoop:
    """The training of a run's scenes, one after another.  The chunked
    path runs a scene as `dispatches` calls of `dispatch`, `nf` frames
    each, and keeps one frame loop for every scene whose prompts have the
    same shapes (a scene with other shapes builds, and on the card
    captures, its own); the per-step loop runs `build_train_step` step by
    step."""

    def __init__(self, par, sampler, cfgs, settings, optimizer, steps: int,
                 save_step: int, contrast: float, dm_every=None, mesh=None):
        self.par, self.sampler, self.cfgs = par, sampler, tuple(cfgs)
        self.settings, self.optimizer = settings, optimizer
        self.steps, self.save_step, self.contrast = steps, save_step, contrast
        self.dm_every, self.mesh = dm_every, mesh
        self.chunked = save_step > 0 and steps % save_step == 0 \
            and steps >= save_step
        self.loops: dict = {}
        from aphantasia_torch.parallel import spatial
        self.spar = par if isinstance(par, spatial.SpatialCanvas) else None
        if self.chunked:
            self.nf = frames_per_dispatch(tuple(par.size), steps // save_step)
            self.dispatches = steps // save_step // self.nf
        elif self.spar is not None:
            self.step_fns = [spatial.build_spatial_train_step(
                par, sampler, cfg, settings, optimizer) for cfg in self.cfgs]
            self.render = spatial.build_spatial_render(par)
        else:
            self.step_fns = [build_train_step(par, sampler, cfg, settings,
                                              optimizer, mesh)
                             for cfg in self.cfgs]
            self.render = build_render(par)
            self.dm_nums = dualmod_steps(steps, dm_every) if dm_every else set()

    def loop_for(self, consts):
        """The frame loop of these towers' prompt shapes."""
        key = tuple(tuple(tuple(e.shape) for e in g[:2])
                    for c in consts for g in c[3])
        if key not in self.loops:
            dual = (None if self.dm_every is None
                    else (self.cfgs[1], self.dm_every))
            args = (self.par, self.sampler, self.cfgs[0], self.settings,
                    self.optimizer, self.save_step, self.nf)
            if self.spar is not None:
                from aphantasia_torch.parallel.spatial import (
                    build_spatial_train_loop_frames)
                self.loops[key] = build_spatial_train_loop_frames(
                    *args, contrast=self.contrast, step_index='step',
                    dual=dual)
            else:
                self.loops[key] = build_train_loop_frames(
                    *args, contrast=self.contrast, step_index='step',
                    dual=dual, mesh=self.mesh)
        return self.loops[key]

    def dispatch(self, c: int, gen_params, opt_state, prev, consts, draws,
                 save_frames=None):
        """Dispatch `c` of a scene on the chunked path: its `nf` frame
        groups through `loop_for(consts)`, the frames handed to
        `save_frames(first, frames)`, the losses read (the dispatch's one
        wait).  Returns (gen_params, opt_state, prev, losses)."""
        loop = self.loop_for(consts)
        extra = () if self.dm_every is None else (
            consts[1][0], consts[1][1], consts[1][3])
        gen_params, opt_state, prev, frames, dl = loop(
            gen_params, opt_state, prev, *consts[0], *extra, draws,
            c * self.nf)
        if save_frames is not None:
            save_frames(c * self.nf, frames)
        with span("loss_read"):
            losses = dl.tolist()          # the dispatch's one wait
        return gen_params, opt_state, prev, losses

    def scene(self, gen_params, opt_state, consts, draws, save_frames=None,
              on_frame=None):
        """One scene of `steps` steps from (gen_params, opt_state) and a
        zero `prev_enc`.  `consts`: one (clip_params, aest_params, None,
        prompts) tuple per tower; `draws(g)` gives the scene's step g's
        StepDraws, called in step order; `save_frames(first, frames)`
        takes the uint8 frames [N,H,W,3] from frame `first` on;
        `on_frame()` is called after each frame.  Returns (gen_params,
        opt_state, losses, step_seconds): on the chunked path (`dispatch`
        after dispatch) each step of a dispatch gets its wall over its
        steps, and each pattern's first frame group (eager run and
        capture) its own."""
        dev = gen_params.device
        prev = torch.zeros((self.sampler.count, self.cfgs[0].embed_dim),
                           device=dev)
        losses, seconds = [], []
        n = self.save_step
        if self.chunked:
            for c in range(self.dispatches):
                t0 = time.perf_counter()
                gen_params, opt_state, prev, dl = self.dispatch(
                    c, gen_params, opt_state, prev, consts, draws,
                    save_frames)
                losses += dl
                seconds += dispatch_seconds(time.perf_counter() - t0,
                                            self.loop_for(consts).first_runs,
                                            self.nf, n)
                for _ in range(self.nf if on_frame is not None else 0):
                    on_frame()
            return gen_params, opt_state, losses, seconds
        for i in range(self.steps):
            t0 = time.perf_counter()
            tower = int(i in self.dm_nums)
            gen_params, opt_state, prev, loss = self.step_fns[tower](
                gen_params, opt_state, prev, *consts[tower], draws(i), i)
            with span("loss_read"):
                losses.append(loss.item())
            seconds.append(time.perf_counter() - t0)
            if i % n == 0:
                if save_frames is not None:
                    save_frames(i // n, self.render(
                        gen_params, contrast=self.contrast)[None])
                if on_frame is not None:
                    on_frame()
        return gen_params, opt_state, losses, seconds


@dataclasses.dataclass
class IllustraSetup:
    """What a run builds before its scenes (`a` is updated as the JAX CLI
    updates it: modsize, samples)."""
    a: argparse.Namespace
    device: torch.device
    scenes: SceneLoop
    draw: object                  # draw(generator) -> StepDraws
    vis: list                     # each tower's vision weights, cast
    aests: list                   # each tower's aesthetic head, or None
    encs: list                    # each tower's (texts, styles, images)
    texts: list
    styles: list

    @property
    def count(self) -> int:
        return max(len(x) for x in self.encs[0])

    def consts(self, num: int) -> list:
        """Scene `num`'s (clip_params, aest_params, None, prompts) of each
        tower.  The prompts are copies: a frame loop keeps the first
        scene's as its buffers and copies the later scenes' into them."""
        out = []
        for v, ae, enc in zip(self.vis, self.aests, self.encs):
            groups = []
            for lst in enc:
                e = pick_(lst, num, self.a.loop)
                if e is not None:
                    groups.append((e[0].clone(), e[1].clone(), -1.0))
            out.append((v, ae, None, groups))
        return out

    def start(self, num: int) -> torch.Tensor:
        """Scene `num`'s fresh spectrum (--resume, else a random init from
        the scene's own generator); on a sharded canvas this rank's
        shard."""
        a = self.a
        p, _ = resume_fft(a.resume, [1, 3, *a.size], a.decay, sd=0.08,
                          generator=scene_generator(a.seed, num, 1,
                                                    self.device))
        p = p.to(device=self.device, dtype=torch.float32).contiguous()
        spar = self.scenes.spar
        return p if spar is None else spar.shard(p)

    def out_name(self, num: int) -> str:
        a = self.a
        names = []
        if a.resume is not None and num == 0:
            names += [basename(a.resume)[:12]]
        if self.texts:
            names += [txt_clean(pick_(self.texts, num, a.loop))[:32]]
        if self.styles:
            names += [txt_clean(pick_(self.styles, num, a.loop))[:32]]
        name = '-'.join(names)
        name += ('' if a.dualmod is not None
                 else '-%s' % a.model.replace('/', '').replace('-', ''))
        if a.enforce != 0:
            name += '-e%.2g' % a.enforce
        if self.count > 1:
            name = '%04d-' % (num + 1) + name
        return name


@dataclasses.dataclass
class IllustraResult:
    out_names: list               # one per finished scene
    params: object                # the last scene's spectrum
    losses: list                  # per scene, one float a step
    step_seconds: list            # per scene, one a step
    samples: int                  # cutouts a step after the budget
    final_frames: int             # crossfade frames written
    video: str | None             # the crossfade video, if any
    scene_loop: SceneLoop


def _fleet_scenes_in(workdir: str, count: int, rank: int) -> bool:
    """On fleet rank 0: whether every scene's snapshot is in `workdir`,
    polled for up to APHANTASIA_FLEET_WAIT seconds (other ranks: False)."""
    if rank != 0:
        return False
    deadline = time.monotonic() + float(
        os.environ.get('APHANTASIA_FLEET_WAIT', '0'))
    while len(file_list(workdir, 'pt')) < count:
        if time.monotonic() >= deadline:
            print(' fleet: %d/%d scene snapshots present: rerun on one host '
                  '(or run interpol on %s) to assemble the piece'
                  % (len(file_list(workdir, 'pt')), count, workdir))
            return False
        time.sleep(2.0)
    return True


def main(argv=None):
    run(get_args(argv))


def setup(a, spatial=None) -> IllustraSetup:
    """The run's pieces; under a spatial axis (`common.spatial_count`)
    the scenes train the sharded spectrum."""
    spatial = spatial_count(a, spatial)
    device = resolve_device(a.device)
    dtype = resolve_dtype(a.precision, device)
    card_settings(device)

    def seeded(seed, dev="cpu"):
        return torch.Generator(device=dev).manual_seed(seed)

    clips = [ClipWrapper(a.model, device, a.clip_weights,
                         generator=seeded(a.seed))]
    a.modsize = clips[0].modsize
    if a.dualmod is not None:
        # the same weights path and seed as the first tower, as in JAX
        clips.append(ClipWrapper('ViT-B/16', device, a.clip_weights,
                                 generator=seeded(a.seed)))
        print(' dual model every %d step' % a.dualmod)
    mesh = (setup_spatial(spatial, getattr(a, 'mesh', None), clips, a.verbose)
            if spatial else setup_mesh(getattr(a, 'mesh', None), clips,
                                       a.verbose))
    a.samples = sample_budget(a.samples, a.model, a.dualmod, a.transform,
                              a.enforce)
    aests = [None] * len(clips)
    if a.aest != 0 and aesthetic_dims(a.model):
        aests = [aesthetic_get(seeded(7 + i, device), c.name, a.aest_weights)
                 for i, c in enumerate(clips)]

    # ---- inputs -----------------------------------------------------------
    texts, styles, img_paths = [], [], []
    if a.in_img is not None and os.path.exists(a.in_img):
        img_paths = (img_list(a.in_img) if os.path.isdir(a.in_img)
                     else [a.in_img])
    if a.in_txt is not None:
        texts = maybe_translate(read_text(a.in_txt), a.translate, a.verbose)
    if a.in_txt2 is not None:
        styles = maybe_translate(read_text(a.in_txt2), a.translate,
                                 a.verbose)

    def enc_all(clip):
        imgs = []
        for i, p in enumerate(img_paths):
            emb, _ = clip.enc_image_sliced(
                img_read(p), a.samples, a.align,
                scene_generator(a.seed, i, 2, device))
            imgs.append((emb, torch.full((emb.shape[0],), 1.0 / emb.shape[0],
                                         device=device)))
        return ([clip.enc_text(t) for t in texts],
                [clip.enc_text(s) for s in styles], imgs)
    encs = [enc_all(c) for c in clips]
    if max(len(x) for x in encs[0]) == 0:
        raise ValueError(' No inputs found!')
    if a.verbose:
        print(' samples:', a.samples)

    # ---- step functions ---------------------------------------------------
    h, w = a.size
    par = FFTParameterizer(tuple(a.size), a.decay, a.colors)
    draw_shape = (1, 3, h, w // 2 + 1, 2)
    if spatial:
        a.samples = round_samples(a.samples, mesh, a.verbose)
        par = spatial_canvas('fft', a.size, mesh, a.decay, a.colors)
        draw_shape = par.draw_shape
    sampler = CutoutSampler(tuple(a.size), a.samples, a.modsize, a.align,
                            a.macro, use_pallas=a.pallas)
    optimizer = build_optimizer(
        'adamw_custom' if a.optimr.lower() == 'adamw' else 'adam_custom',
        a.lrate)
    settings = StepSettings(
        sim=a.sim or 'cossim', sharp=a.sharp, aest=a.aest,
        enforce=a.enforce, expand=0.0, noise=a.noise, noise_centered=True,
        total_steps=max(a.steps // a.save_step, 1), transform=a.transform,
        persp=resolve_persp(a.persp), clip_dtype=dtype)
    scenes = SceneLoop(par, sampler, [c.cfg for c in clips], settings,
                       optimizer, a.steps, a.save_step, a.contrast,
                       a.dualmod, mesh)
    return IllustraSetup(
        a, device, scenes, build_draw_fn(sampler, settings, draw_shape),
        [c.vision(dtype) for c in clips], aests, encs, texts, styles)


def run(a) -> IllustraResult:
    """The whole run (under --mesh, rank 0's result)."""
    return run_cli(a, _run)


def _run(a, spatial=None) -> IllustraResult:
    """The run on this rank; `spatial` as `setup` takes it."""
    su = setup(a, spatial)
    scenes, workdir = su.scenes, a.out_dir
    spar = scenes.spar
    primary = mesh_primary()
    if primary:
        os.makedirs(workdir, exist_ok=True)
    gen_params = opt_state = None
    res = IllustraResult([], None, [], [], a.samples, 0, None, scenes)
    # the fleet renders its scenes round robin, each fresh
    rank, world = fleet_info()
    fleet = world > 1
    scene_ids = shard_scenes(su.count) if fleet else list(range(su.count))
    if fleet:
        print(' fleet %d/%d: scenes %s of %d' % (rank, world, scene_ids,
                                               su.count))
    with frame_writer() as writer:
        try:
            for num in scene_ids:
                if num == scene_ids[0] or a.separate or fleet:
                    gen_params = su.start(num)
                    opt_state = scenes.optimizer.init(gen_params)
                else:
                    # the last scene's spectrum rescaled, its optimizer
                    # state carried over
                    gen_params = keep_chain(gen_params, a.keep, spar)
                out_name = su.out_name(num)
                if a.verbose:
                    print(out_name)
                tempdir = os.path.join(workdir, out_name)
                if primary:
                    os.makedirs(tempdir, exist_ok=True)
                    if num == scene_ids[0] and rank == 0:
                        save_cfg(a, workdir, out_name + '.txt')

                pbar = (ProgressBar(a.steps // a.save_step) if a.verbose
                        else None)
                gen = scene_generator(a.seed, num, 0, su.device)
                gen_params, opt_state, losses, secs = scenes.scene(
                    gen_params, opt_state, su.consts(num),
                    lambda g, gen=gen: su.draw(gen),
                    lambda first, frames, d=tempdir: writer.save_batch(
                        [os.path.join(d, '%04d.jpg' % (first + j))
                         for j in range(len(frames))], frames),
                    pbar.upd if pbar is not None else None)

                writer.flush()
                # on a sharded canvas every rank gathers the spectrum
                final = gen_params if spar is None else spar.full(gen_params)
                if primary:
                    frames = img_list(tempdir)
                    if frames:
                        shutil.copy(frames[-1], os.path.join(
                            workdir, '%s-%d.jpg' % (out_name, a.steps)))
                    frames_to_video(tempdir, os.path.join(
                        workdir, out_name + '.mp4'), fps=a.fps)
                    if a.save_pt:
                        # a bare tensor, as the reference saves it
                        save_pt('%s.pt' % os.path.join(workdir, out_name),
                                final)
                res.out_names.append(out_name)
                res.losses.append(losses)
                res.step_seconds.append(secs)
                res.params = final
        except KeyboardInterrupt:
            print(' interrupted: assembling the finished scenes')

    # ---- the crossfade (rank 0 of the fleet, once every scene is in) ------
    if not primary or (fleet and not a.separate
                       and not _fleet_scenes_in(workdir, su.count, rank)):
        return res
    if not a.separate:
        vsteps = (a.lsteps if a.length is None
                  else int(a.length * a.fps / su.count))
        tempdir = os.path.join(workdir, '_final')
        os.makedirs(tempdir, exist_ok=True)
        if a.verbose:
            print(' rendering complete piece')
        res.final_frames = crossfade(FFTParameterizer(tuple(a.size), a.decay,
                                                      a.colors), a.contrast,
                                     file_list(workdir, 'pt'), vsteps,
                                     tempdir, su.device, a.verbose)
        name = basename(a.in_txt) if a.in_txt else 'final'
        res.video = frames_to_video(tempdir, os.path.join(a.out_dir,
                                                          name + '.mp4'),
                                    pattern='%05d.jpg', fps=a.fps)
    return res


if __name__ == '__main__':
    main()
