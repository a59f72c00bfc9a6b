"""illustrip: continuous text-to-video with pan, zoom, rotation and shear,
and the Depth-Anything-V2 3D warp (counterpart of
aphantasia_tpu.cli.illustrip).

Same flags, defaults and outputs as the JAX CLI, plus `--device`.  Each
scene (a line of the text file) crossfades its prompts into the next
scene's over its `--steps` frames (`get_encs`); a 4-track motion schedule
(`motion/anima.py:motion_schedule`) moves every frame: the RGB pixels are
warped directly, the FFT spectrum through its image and back.  A frame
is one call of `step.build_frame_step`: the motion warp, a fresh Adam
state (or with --smooth the carried one), `--opt_step` train steps and the
uint8 render after the last.  With `--depth` the frame first warps the
state by the mirror-fused depth of its last preview, which one DA-V2
forward computes after each frame.  Frames go to `<workdir>/ttt/%06d.jpg`
through the frame writer, then into `<workdir>/<name>.mp4`.  Runs on the
CUDA device unless `--device cpu` is given; without a GPU it raises.

On the card every frame group (one per tower and prompt shape) runs its
first frame eagerly and is captured into a CUDA graph; later frames copy
their motion scalars, step index, draws, prompt weights and depth map
into its buffers and replay.  The DA-V2 forward is a graph of its own.
The host does not wait for a frame: the frame is pulled into pinned
memory behind the replay, and the writer's threads encode it.  --mesh
N|NxM|dcn runs the frames' steps over mesh ranks (`common.run_cli`), rank
0 writing; --fleet runs the whole job on each host, as in JAX.
--spatial N (N > 1) shards the frame state over N ranks a data rank
(`parallel/spatial.py`: `SpatialRGB`'s rows or `SpatialFFT`'s spectrum
columns by --gen), with --mesh N|NxM as in JAX: each frame gathers the
frame once for its motion (and depth) warp, trains the sharded state and
renders the gathered frame.

    python -m aphantasia_torch.cli.illustrip -t scenes.txt
    python -m aphantasia_torch.cli.illustrip -t scenes.txt --gen FFT --smooth
    python -m aphantasia_torch.cli.illustrip -t scenes.txt --depth 1 \\
        --depth_dir _out/depth
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import shutil
import time

import numpy as np
import torch

from aphantasia_torch.cli.common import (
    ClipWrapper, add_parallel_flags, apply_sample_budget,
    build_prompt_groups, card_settings, dualmod_steps, frame_writer,
    maybe_translate, parse_size, resolve_dtype, resolve_persp, round_samples,
    run_cli, setup_mesh, setup_spatial, spatial_canvas, spatial_count)
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.encoder import depth_tone
from aphantasia_torch.io.media import (basename, file_list, frames_to_video,
                                       img_read)
from aphantasia_torch.motion.anima import motion_schedule
from aphantasia_torch.ops.losses import aesthetic_dims, aesthetic_get
from aphantasia_torch.ops.optim import build_optimizer
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer, resume_fft
from aphantasia_torch.params.pixel import PixelParameterizer, resume_pixel
from aphantasia_torch.parallel.mesh import mesh_primary
from aphantasia_torch.profiling import collect, span
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.step import (StepSettings, build_depth_helpers,
                                   build_draw_fn, build_frame_step)
from aphantasia_torch.utils import (intrl, pick_, read_text, save_cfg,
                                    txt_clean)
from aphantasia_torch.weights import env_weights

CLIP_MODELS = ['ViT-B/16', 'ViT-B/32', 'RN50', 'RN50x4', 'RN50x16', 'RN101']


def _save_depth_map(writer, dmap, depth_dir, num, size):
    """The depth-map JPEG of a frame: the fused map at the DA-V2 size is
    pulled by the writer, and resized to the frame in its encoder process
    (`depth_tone`)."""
    writer.save_batch([os.path.join(depth_dir, '%05d.jpg' % num)], dmap[0],
                      functools.partial(depth_tone, size=tuple(size)))


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-s',  '--size',    default='1280-720')
    parser.add_argument('-t',  '--in_txt',  default=None, help='Text string or file (main topic)')
    parser.add_argument('-pre', '--in_txt_pre', default=None)
    parser.add_argument('-post', '--in_txt_post', default=None)
    parser.add_argument('-t2', '--in_txt2', default=None, help='Text string or file (style)')
    parser.add_argument('-t0', '--in_txt0', default=None, help='input text to subtract')
    parser.add_argument('-im', '--in_img',  default=None, help='input image or directory')
    parser.add_argument('-wi', '--weight_img', default=0.5, type=float)
    parser.add_argument('-r',  '--resume',  default=None)
    parser.add_argument('--out_dir', default='_out')
    parser.add_argument('-tr', '--translate', action='store_true')
    parser.add_argument('--invert',  action='store_true')
    parser.add_argument('-v',  '--verbose',    dest='verbose', action='store_true')
    parser.add_argument('-nv', '--no-verbose', dest='verbose', action='store_false')
    parser.set_defaults(verbose=True)
    # training
    parser.add_argument('--gen',     default='RGB', help='Generation method: FFT or RGB')
    parser.add_argument('-m',  '--model',   default='ViT-B/32', choices=CLIP_MODELS)
    parser.add_argument('--steps',   default=300, type=int, help='Iterations (frames) per scene')
    parser.add_argument('--samples', default=100, type=int)
    parser.add_argument('-lr', '--lrate',   default=0.1, type=float)
    parser.add_argument('-dm', '--dualmod', default=None, type=int)
    # motion
    parser.add_argument('-ops', '--opt_step', default=1, type=int, help='Optimizing steps per save/transform step')
    parser.add_argument('-sm', '--smooth',  action='store_true', help='Smoothen interframe jittering for FFT method')
    parser.add_argument('-it', '--interpol', default=True, help='Interpolate topics?')
    parser.add_argument('--fstep',   default=100, type=int, help='Frames before changing motion')
    parser.add_argument('--scale',   default=0.012, type=float)
    parser.add_argument('--shift',   default=10., type=float)
    parser.add_argument('--angle',   default=0.8, type=float)
    parser.add_argument('--shear',   default=0.4, type=float)
    parser.add_argument('--anima',   default=True)
    # depth
    parser.add_argument('-d',  '--depth',   default=0, type=float)
    parser.add_argument('--depth_model', default='b', help='large, base or small')
    parser.add_argument('--depth_dir',   default=None)
    # tweaks
    parser.add_argument('-a',  '--align',   default='overscan', choices=['central', 'uniform', 'overscan', 'overmax'])
    parser.add_argument('-tf', '--transform', default='fast', choices=['none', 'fast', 'custom', 'elastic', 'lucent', 'openai'])
    parser.add_argument('-opt', '--optimizer', default='adam_custom', choices=['adam', 'adam_custom', 'adamw', 'adamw_custom'])
    parser.add_argument('--fixcontrast', action='store_true')
    parser.add_argument('--contrast', default=1.2, type=float)
    parser.add_argument('--colors',  default=2.3, type=float)
    parser.add_argument('-sh', '--sharp',   default=0, type=float)
    parser.add_argument('-mc', '--macro',   default=0.3, type=float)
    parser.add_argument('--aest',    default=0., type=float)
    parser.add_argument('-e',  '--enforce', default=0, type=float)
    parser.add_argument('-x',  '--expand',  default=0, type=float)
    parser.add_argument('-n',  '--noise',   default=2., type=float, help='FFT only')
    parser.add_argument('--sim',     default='mix')
    parser.add_argument('--rem',     default=None, help='Dummy text to add to project name')
    parser.add_argument('--clip_weights', default=None)
    parser.add_argument('--aest_weights', default=None)
    parser.add_argument('--depth_weights', default=None)
    parser.add_argument('--precision', default='auto', choices=['auto', 'bf16', 'fp32'])
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--spatial', default=0, type=int,
                        help='Shard the frame state spatially over N ranks')
    add_parallel_flags(parser)
    a = parser.parse_args(argv)
    if a.dualmod is not None and a.dualmod < 1:
        parser.error('--dualmod must be a positive step interval')

    a.size = parse_size(a.size)
    a.gen = a.gen.upper()
    a.invert = -1.0 if a.invert is True else 1.0
    if a.gen == 'RGB':
        a.smooth = False
        a.align = 'overscan'
        if a.resume is not None:
            a.fixcontrast = True
    if a.model == 'ViT-B/16':
        a.sim = 'cossim'
    if a.dualmod is not None:
        a.model = 'ViT-B/32'
        a.sim = 'cossim'
    return a


def get_encs(encs, num, steps, interpol=True):
    """Scene `num`'s prompt crossfade: encs is a list of (embs [K,D], wts
    [K]) per scene; returns `steps` entries, each a list of (embs, wts)
    with the scene's weights fading out and the next scene's in."""
    cnt = len(encs)
    if cnt == 0:
        return []
    enc_1 = encs[min(num, cnt - 1)]
    enc_2 = encs[min(num + 1, cnt - 1)]
    if interpol is not True:
        return [[enc_1]] * steps
    out = []
    for i in range(steps):
        step_encs = []
        if enc_1 is not None:
            step_encs.append((enc_1[0], enc_1[1] * (steps - i) / steps))
        if enc_2 is not None:
            step_encs.append((enc_2[0], enc_2[1] * i / steps))
        out.append(step_encs)
    return out


@dataclasses.dataclass
class IllustripSetup:
    """What a run builds before its frames (`a` is updated as the JAX CLI
    updates it: size, fstep, modsize, samples)."""
    a: argparse.Namespace
    device: torch.device
    par: object                   # PixelParameterizer or FFTParameterizer
    sampler: CutoutSampler
    settings: StepSettings
    optimizer: object
    draw: object                  # draw(generator) -> StepDraws
    gen: torch.Generator          # the run's generator, after the init
    params: torch.Tensor          # the start params
    towers: list                  # per tower (cfg, vision weights, aest)
    encs: list                    # per tower (texts, styles, subtracts,
    #                               images), each a list of (embs, wts)
    texts: list
    styles: list
    count: int                    # scenes
    schedule: tuple | None        # (scale, shift, angle, shear) tracks
    deptha: object                # InferDepthAny, or None
    workdir: str
    tempdir: str
    workname: str
    mesh: object = None           # this rank's parallel.mesh.Mesh, or None
    spar: object = None           # the sharded canvas under --spatial

    def frame_steps(self) -> list:
        """One frame step per tower."""
        a = self.a
        if self.spar is not None:
            from aphantasia_torch.parallel.spatial import (
                build_spatial_frame_step)
            return [build_spatial_frame_step(
                self.spar, self.sampler, cfg, self.settings, self.optimizer,
                a.opt_step, a.smooth, a.contrast, deptha=self.deptha,
                depth=a.depth) for cfg, _, _ in self.towers]
        return [build_frame_step(
            self.par, self.sampler, cfg, self.settings, self.optimizer,
            a.gen, tuple(a.size), a.opt_step, a.smooth, a.contrast,
            deptha=self.deptha, depth=a.depth, colors=a.colors,
            mesh=self.mesh) for cfg, _, _ in self.towers]

    def depth_helpers(self):
        """`build_depth_helpers`' pair, or None without the depth warp."""
        if self.deptha is None or self.a.depth <= 0:
            return None
        if self.spar is not None:
            from aphantasia_torch.parallel.spatial import (
                build_spatial_depth_helpers)
            return build_spatial_depth_helpers(self.spar, self.deptha)
        return build_depth_helpers(self.a.gen, tuple(self.a.size),
                                   self.deptha, self.a.colors)

    def scene(self, num: int) -> list:
        """Scene `num`'s four crossfade schedules (texts, styles,
        subtracts, images), the second tower's interleaved every
        --dualmod frames; a span "scene"."""
        with span("scene"):
            a = self.a
            sched = [get_encs(e, num, a.steps, a.interpol)
                     for e in self.encs[0]]
            if len(self.encs) > 1:
                second = [get_encs(e, num, a.steps, a.interpol)
                          for e in self.encs[1]]
                sched = [intrl(s, s2, a.dualmod) if s else s
                         for s, s2 in zip(sched, second)]
            return sched

    def frame(self, sched, num: int, ii: int):
        """Frame `ii` of scene `num`: (tower, prompt groups, motion); a
        span "frame.plan"."""
        with span("frame.plan"):
            return self._plan(sched, num, ii)

    def _plan(self, sched, num: int, ii: int):
        a = self.a
        tower = int(len(self.towers) > 1
                    and ii in dualmod_steps(a.steps, a.dualmod))
        txt, styl, notx, imgs = sched
        groups = []
        for encs in sched:
            if not encs:
                continue
            coeff = (-a.invert if encs is txt
                     else 1.0 if encs is notx
                     else -a.weight_img if encs is imgs else -1.0)
            for embs, wts in encs[ii % len(encs)]:
                groups.append((embs, wts, coeff))
        glob_step = num * a.steps + ii
        if self.schedule is not None:
            m_scale, m_shift, m_angle, m_shear = self.schedule
            motion = (float(m_angle[glob_step][0]),
                      float(m_shift[glob_step][0]),
                      float(m_shift[glob_step][1]),
                      float(m_scale[glob_step, 0]),
                      float(m_shear[glob_step][0]))
        else:
            motion = (a.angle, 0.0, a.shift, 1 + a.scale, a.shear)
        return tower, build_prompt_groups(groups), motion


@dataclasses.dataclass
class IllustripResult:
    workdir: str
    video: str | None
    samples: int                  # cutouts a step after the budget
    frames: int                   # frames written
    losses: list                  # per frame, one float a step
    starts: list                  # host clock at each frame's start (its
    #                               "frame.plan" span's)
    host: list                    # per frame the host seconds of its
    #                               prompts and draws, of its dispatch (the
    #                               frame step and the depth forward) and
    #                               of the writer's admit, from its spans
    end: float                    # host clock after the last frame's work,
    #                               the device drained
    first_frames: list            # frames that ran a group's first run
    #                               (on the card its eager run and capture)
    frame_steps: list             # the frame step of each tower
    depth: object                 # the depth helpers, or None
    params: torch.Tensor          # the last frame's state


def main(argv=None):
    run(get_args(argv))


def _seeded(*seed, device="cpu") -> torch.Generator:
    """A generator seeded from the integers `seed` alone."""
    state = np.random.SeedSequence(list(seed)).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def setup(a, spatial=None) -> IllustripSetup:
    """The run's pieces; under a spatial axis (`common.spatial_count`)
    the frame state is this rank's shard of the sharded canvas."""
    spatial = spatial_count(a, spatial)
    device = resolve_device(a.device)
    dtype = resolve_dtype(a.precision, device)
    card_settings(device)

    def seeded(seed, dev="cpu"):
        return torch.Generator(device=dev).manual_seed(seed)

    clips = [ClipWrapper(a.model, device, a.clip_weights,
                         generator=seeded(a.seed))]
    a.modsize = clips[0].modsize
    if a.verbose:
        print(' using model', a.model)
    if a.dualmod is not None:
        # the same weights path and seed as the first tower, as in JAX
        clips.append(ClipWrapper('ViT-B/16', device, a.clip_weights,
                                 generator=seeded(a.seed)))
        print(' dual model every %d step' % a.dualmod)
    mesh = (setup_spatial(spatial, getattr(a, 'mesh', None), clips, a.verbose)
            if spatial else setup_mesh(getattr(a, 'mesh', None), clips,
                                       a.verbose))
    aests = [None] * len(clips)
    if a.aest != 0 and aesthetic_dims(a.model):
        aests = [aesthetic_get(seeded(7 + i, device), c.name, a.aest_weights)
                 for i, c in enumerate(clips)]
    a.samples = apply_sample_budget(a.samples, a.model, a.dualmod, a.enforce,
                                    0, a.transform)

    # ---- inputs (lists per scene) -----------------------------------------
    texts, styles, notexts, images = [], [], [], []
    if a.in_txt is not None:
        texts = read_text(a.in_txt)
    if a.in_txt_pre is not None:
        pre = read_text(a.in_txt_pre)
        texts = [' | '.join([pick_(pre, n), texts[n]]).strip()
                 for n in range(len(texts))]
    if a.in_txt_post is not None:
        post = read_text(a.in_txt_post)
        texts = [' | '.join([texts[n], pick_(post, n)]).strip()
                 for n in range(len(texts))]
    texts = maybe_translate(texts, a.translate, a.verbose)
    if a.in_txt2 is not None:
        styles = maybe_translate(read_text(a.in_txt2), a.translate, a.verbose)
    if a.in_txt0 is not None:
        notexts = maybe_translate(read_text(a.in_txt0), a.translate,
                                  a.verbose)
    if a.in_img is not None and os.path.exists(a.in_img):
        images = (file_list(a.in_img) if os.path.isdir(a.in_img)
                  else [a.in_img])

    def enc_all(clip):
        imgs = []
        for i, p in enumerate(images):
            emb, _ = clip.enc_image_sliced(img_read(p), a.samples, a.align,
                                           _seeded(a.seed, 200 + i,
                                                   device=device))
            imgs.append((emb, torch.full((emb.shape[0],), 1.0 / emb.shape[0],
                                         device=device)))
        return ([clip.enc_text(t) for t in texts],
                [clip.enc_text(s) for s in styles],
                [clip.enc_text(s) for s in notexts], imgs)
    encs = [enc_all(c) for c in clips]
    count = max(len(x) for x in encs[0])
    if count == 0:
        raise ValueError(' No inputs found!')
    if a.verbose:
        print(' samples:', a.samples)

    # ---- parameter state --------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(a.seed)
    shape = [1, 3, *a.size]
    if a.gen == 'RGB':
        params, sz = resume_pixel(a.resume, shape, generator=gen)
        if isinstance(params, list):
            params = params[0]
    else:
        params, sz = resume_fft(a.resume, shape, decay=1.5, sd=1,
                                generator=gen)
    if sz is not None:
        a.size = list(sz)
    params = params.to(device=device, dtype=torch.float32).contiguous()

    deptha = None
    if a.depth != 0:
        from aphantasia_torch.models.depth_anything import InferDepthAny
        depth_w = env_weights('dav2', a.depth_weights)
        params_d = None
        if depth_w:
            from aphantasia_torch.models.depth_anything.convert import (
                convert_hf_dav2)
            params_d = convert_hf_dav2(depth_w)
        deptha = InferDepthAny(a.depth_model, params=params_d, dtype=dtype,
                               device=device)
        if a.depth_dir is not None:
            if mesh_primary():
                os.makedirs(a.depth_dir, exist_ok=True)
            print(' depth dir:', a.depth_dir)

    glob_steps = count * a.steps
    if glob_steps == a.fstep:
        a.fstep = glob_steps // 2  # otherwise no motion

    workname = txt_clean(basename(a.in_txt) if a.in_txt is not None
                         else basename(a.in_img))
    workdir = os.path.join(a.out_dir, workname + '-%s' % a.gen.lower())
    if a.rem is not None:
        workdir += '-%s' % a.rem
    if a.dualmod is not None:
        workdir += '-dm%d' % a.dualmod
    if 'RN' in a.model.upper():
        workdir += '-%s' % a.model
    tempdir = os.path.join(workdir, 'ttt')
    if mesh_primary():
        os.makedirs(tempdir, exist_ok=True)
        save_cfg(a, workdir)
        if a.in_txt is not None and os.path.isfile(a.in_txt):
            shutil.copy(a.in_txt, os.path.join(workdir,
                                               os.path.basename(a.in_txt)))
    schedule = (motion_schedule(glob_steps, a.fstep, a.gen, a.scale, a.shift,
                                a.angle, a.shear, seed=a.seed)
                if a.anima else None)

    # ---- the frame step's pieces ------------------------------------------
    par = (PixelParameterizer(tuple(a.size), a.colors, a.fixcontrast)
           if a.gen == 'RGB'
           else FFTParameterizer(tuple(a.size), 1.0, a.colors))
    spar = None
    draw_shape = tuple(params.shape)
    if spatial:
        a.samples = round_samples(a.samples, mesh, a.verbose)
        spar = spatial_canvas(a.gen.lower(), a.size, mesh, 1.0, a.colors,
                              fixcontrast=a.fixcontrast)
        params = spar.shard(params)
        draw_shape = spar.draw_shape
    sampler = CutoutSampler(tuple(a.size), a.samples, a.modsize, a.align,
                            a.macro, use_pallas=a.pallas)
    settings = StepSettings(
        sim=a.sim or 'cossim', sharp=a.sharp, sharp_mode='naiv',
        aest=a.aest, enforce=a.enforce, expand=a.expand,
        noise=a.noise if a.gen == 'FFT' else 0.0, noise_centered=True,
        total_steps=a.steps, rgb_anchors=(a.gen == 'RGB'),
        transform=a.transform, persp=resolve_persp(a.persp), clip_dtype=dtype)
    optimizer = build_optimizer(a.optimizer, a.lrate)
    draw = build_draw_fn(sampler, settings, draw_shape)
    towers = [(c.cfg, c.vision(dtype), ae) for c, ae in zip(clips, aests)]
    return IllustripSetup(a, device, par, sampler, settings, optimizer, draw,
                          gen, params, towers, encs, texts, styles, count,
                          schedule, deptha, workdir, tempdir, workname, mesh,
                          spar)


def _frame_host(spans) -> tuple:
    """(start, (prep, dispatch, admit) seconds) of a frame from the spans
    its loop body made: its "frame.plan" to the end of its last "draw",
    from there to its last "writer.admit" (the frame step and the depth
    forward), and that admit.  The depth map's own writer admit, made
    before the frame step, is the dispatch's.  A rank that writes nothing
    admits nothing: its dispatch ends with its last span."""
    plan = next(s for s in spans if s.name == "frame.plan")
    drawn = max(s.t1 for s in spans if s.name == "draw")
    admits = [s for s in spans if s.name == "writer.admit"]
    end = admits[-1].t0 if admits else spans[-1].t1
    return plan.t0 / 1e9, ((drawn - plan.t0) / 1e9, (end - drawn) / 1e9,
                           admits[-1].seconds if admits else 0.0)


def run(a) -> IllustripResult:
    """The whole run (under --mesh, rank 0's result)."""
    return run_cli(a, _run)


def _run(a, spatial=None) -> IllustripResult:
    """The run on this rank; `spatial` as `setup` takes it."""
    su = setup(a, spatial)
    fss = su.frame_steps()
    helpers = su.depth_helpers()
    h, w = a.size
    params = su.params
    opt_state = su.optimizer.init(params)
    prev_enc = torch.zeros((a.samples, su.towers[0][0].embed_dim),
                           device=su.device)
    res = IllustripResult(su.workdir, None, a.samples, 0, [], [], [], 0.0,
                          [],
                          fss, helpers, params)
    dmap_pending = None

    def captures() -> int:
        n = sum(g.first_seconds is not None
                for fs in fss for g in fs.groups.values())
        return n + int(helpers is not None
                       and helpers.infer.first_seconds is not None)

    with frame_writer() as writer:
        try:
            for num in range(su.count):
                sched = su.scene(num)
                if a.verbose:
                    if su.texts:
                        print(' ref text: ',
                              su.texts[min(num, len(su.texts) - 1)][:80])
                    if su.styles:
                        print(' ref style: ',
                              su.styles[min(num, len(su.styles) - 1)][:80])
                pbar = ProgressBar(a.steps) if a.verbose else None
                for ii in range(a.steps):
                    before = captures()
                    glob_step = num * a.steps + ii
                    with collect() as spans:
                        tower, prompts, motion = su.frame(sched, num, ii)
                        draws = [su.draw(su.gen) for _ in range(a.opt_step)]
                        args = (params, opt_state, prev_enc,
                                su.towers[tower][1], su.towers[tower][2],
                                prompts, draws, ii, motion)
                        if helpers is not None:
                            if dmap_pending is None:    # the first frame's
                                dmap_pending = helpers.infer(
                                    helpers.preview(params))
                            dmap = dmap_pending
                            if a.depth_dir is not None:
                                _save_depth_map(writer, dmap, a.depth_dir,
                                                glob_step, (h, w))
                            (params, opt_state, prev_enc, frame, losses,
                             preview) = fss[tower](*args, dmap)
                            # the next frame's depth, queued behind it
                            dmap_pending = helpers.infer(preview)
                        else:
                            params, opt_state, prev_enc, frame, losses = \
                                fss[tower](*args)
                        writer.save_batch([os.path.join(
                            su.tempdir, '%06d.jpg' % glob_step)], frame[None])
                    start, host = _frame_host(spans)
                    res.starts.append(start)
                    res.host.append(host)
                    res.losses.append(losses)
                    if captures() > before:
                        res.first_frames.append(glob_step)
                    res.frames += 1
                    if pbar is not None:
                        pbar.upd()
        except KeyboardInterrupt:
            pass
    if su.device.type == "cuda":
        torch.cuda.synchronize(su.device)
    res.end = time.perf_counter()
    res.losses = [l.tolist() for l in res.losses]
    # on a sharded canvas every rank gathers the canonical state
    res.params = params if su.spar is None else su.spar.full(params)
    if mesh_primary():
        res.video = frames_to_video(su.tempdir, os.path.join(
            su.workdir, su.workname + '.mp4'), pattern='%06d.jpg')
    return res


if __name__ == '__main__':
    main()
