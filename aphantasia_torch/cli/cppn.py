"""cppn: a CPPN or SIREN coordinate net trained against CLIP, with `.npy`
snapshots and shader export (counterpart of aphantasia_tpu.cli.cppn).

Same flags, defaults and outputs as the JAX CLI: `<out_dir>/cppn/<name>/`
holds a `%04d.jpg` frame and a `%04d.npy` snapshot every `--fstep` steps;
beside it `<name>.npy` (the final net), the five shader targets of
`shader_expo.export_all` (`<name>-td.glsl`, `<name>.tfx`, `<name>.txt`,
`<name>-bookofshaders.glsl`, `<name>-shadertoy.glsl`), `<name>.avi` and
the last frame `<name>-<steps>.jpg`.  `--export -r net.npy` writes the
shaders and a `.jpg` of a snapshot and trains nothing.  `--gen siren`
takes a sine net with its own defaults (256 wide, 5 layers, lr 1e-4).
Optimizer Adam (b1 0.9), plain cossim, sobel sharpness; the prompts
weigh -1 (text), +0.5 (text to subtract) and -1 (image).  The sample
budget is this CLI's own (its XMEM table, x0.69 under --dualmod, x0.95
with -tf).

Training takes the chunked path when `--fstep` divides `--steps`
(`build_train_loop_frames` with the global step as the loss's step index
and `with_params`: each frame group's params at its render point come back
with its frame; on the card one captured graph a tower pattern, the
snapshots read once a dispatch); otherwise the per-step loop.  Runs on the
CUDA device unless `--device cpu` is given; without a GPU it raises.
--mesh N|NxM|dcn runs the steps over mesh ranks (`common.run_cli`), rank
0 writing; --fleet runs the whole job on each host, as in JAX.

    python -m aphantasia_torch.cli.cppn -t "a lighthouse"
    python -m aphantasia_torch.cli.cppn -t "a lighthouse" --gen siren
    python -m aphantasia_torch.cli.cppn -r _out/cppn/x-l10-n24.npy --export
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time

import torch

from aphantasia_torch.cli.common import (
    ClipWrapper, RunSetup, Tower, add_parallel_flags, build_prompt_groups,
    card_settings, dispatch_seconds, dualmod_steps,
    frame_writer, maybe_translate, parse_size, resolve_dtype, resolve_persp,
    run_cli, setup_mesh)
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.media import (basename, checkout, frames_to_video,
                                       img_list, img_read)
from aphantasia_torch.models.clip.model import XMEM
from aphantasia_torch.ops.losses import aesthetic_dims, aesthetic_get
from aphantasia_torch.ops.optim import build_optimizer
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params import cppn as cppn_mod
from aphantasia_torch.params import siren as siren_mod
from aphantasia_torch.params.cppn import CPPNParameterizer, export_npy
from aphantasia_torch.params.siren import SIRENParameterizer
from aphantasia_torch.parallel.mesh import mesh_primary
from aphantasia_torch.profiling import trace
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.shader_expo import export_all
from aphantasia_torch.step import (StepSettings, build_draw_fn, build_render,
                                   build_train_loop_frames, build_train_step,
                                   frames_per_dispatch)
from aphantasia_torch.utils import txt_clean

CLIP_MODELS = ['ViT-B/16', 'ViT-B/32', 'ViT-L/14', 'RN50', 'RN50x4',
               'RN50x16', 'RN50x64', 'RN101']
# the reference's own table: ViT-L/14 x0.11 and RN50x64 x0.04
XMEM_CPPN = dict(XMEM, **{"ViT-L/14": 0.11, "RN50x64": 0.04})


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-i',  '--in_img',  default=None, help='input image')
    parser.add_argument('-t',  '--in_txt',  default=None, help='input text')
    parser.add_argument('-t0', '--in_txt0', default=None, help='input text to subtract')
    parser.add_argument('--out_dir', default='_out')
    parser.add_argument('-r',  '--resume',  default=None, help='Input CPPN model (NPY file)')
    parser.add_argument('-s',  '--size',    default='512-512')
    parser.add_argument('--fstep',   default=1, type=int, help='Saving step')
    parser.add_argument('-tr', '--translate', action='store_true')
    parser.add_argument('-v',  '--verbose', action='store_true')
    parser.add_argument('-ex', '--export',  action='store_true', help='Only export shaders from snapshot')
    # networks
    parser.add_argument('-gen', '--generator', default='cppn', choices=['cppn', 'siren'],
                        help='coordinate net: CPPN (atan MLP) or SIREN (sine MLP)')
    parser.add_argument('-l',  '--layers',  default=None, type=int)
    parser.add_argument('-nf', '--nf',      default=None, type=int)
    parser.add_argument('-act', '--actfn',  default='unbias', choices=['unbias', 'comp', 'relu'])
    parser.add_argument('--w0',       default=30., type=float, help='SIREN hidden frequency')
    parser.add_argument('--w0_first', default=30., type=float, help='SIREN first-layer frequency')
    parser.add_argument('-dec', '--decim',  default=3, type=int, help='Decimal precision for export')
    # training
    parser.add_argument('-m',  '--model',   default='ViT-B/32', choices=CLIP_MODELS)
    parser.add_argument('-dm', '--dualmod', default=None, type=int)
    parser.add_argument('--steps',   default=200, type=int)
    parser.add_argument('--samples', default=50, type=int)
    parser.add_argument('-lr', '--lrate',   default=None, type=float)
    parser.add_argument('-a',  '--align',   default='overscan', choices=['central', 'uniform', 'overscan'])
    parser.add_argument('-sh', '--sharp',   default=0, type=float)
    parser.add_argument('-tf', '--transform', action='store_true', help='use augmenting transforms?')
    parser.add_argument('-mc', '--macro',   default=0.4, type=float)
    parser.add_argument('--aest',    default=0., type=float)
    parser.add_argument('--clip_weights', default=None)
    parser.add_argument('--aest_weights', default=None)
    parser.add_argument('--precision', default='auto', choices=['auto', 'bf16', 'fp32'])
    parser.add_argument('--seed', default=0, type=int)
    add_parallel_flags(parser)
    a = parser.parse_args(argv)
    if a.dualmod is not None and a.dualmod < 1:
        parser.error('--dualmod must be a positive step interval')
    a.size = parse_size(a.size)
    if a.dualmod is not None:
        a.model = 'ViT-B/32'
    # per-generator defaults (SIREN: wide and shallow, a small lr)
    siren = a.generator == 'siren'
    if a.nf is None:
        a.nf = 256 if siren else 24
    if a.layers is None:
        a.layers = 5 if siren else 10
    if a.lrate is None:
        a.lrate = 1e-4 if siren else 0.003
    return a


@dataclasses.dataclass
class RunResult:
    params: list                  # the final net, [w0, b0, w1, b1, ...]
    losses: list                  # one float per step
    step_seconds: list            # as clip_fft's RunResult
    samples: int                  # cutouts per step after the budget
    out_base: str                 # <out_dir>/cppn/<name>, the frame dir
    video: str | None             # the video written, if any
    loop: object = None           # the chunked path's FrameLoop, if taken


def main(argv=None):
    run(get_args(argv))


def build_parameterizer(a, generator: torch.Generator):
    """(parameterizer, params on the generator's device) from --resume (the
    architecture read from the snapshot, `a` updated) or a fresh init."""
    dev = generator.device
    siren = a.generator == 'siren'
    if a.resume is not None and os.path.isfile(a.resume):
        if siren:
            params, a.nf, a.layers = siren_mod.load_npy(a.resume, dev)
        else:
            params, a.nf, a.layers, a.actfn = cppn_mod.load_npy(a.resume, dev)
        print(' loaded:', a.resume)
    if siren:
        par = SIRENParameterizer(tuple(a.size), a.nf, a.layers, a.w0,
                                 a.w0_first)
    else:
        par = CPPNParameterizer(tuple(a.size), a.nf, a.layers, a.actfn)
    if a.resume is None or not os.path.isfile(a.resume):
        params = par.init(generator)
    return par, params


def shader_layers(a, params):
    if a.generator == 'siren':
        return siren_mod.to_shader_layers(params, a.w0, a.w0_first)
    return cppn_mod.to_shader_layers(params, a.actfn)


def setup(a):
    """The run's net, towers, prompts and step pieces and its work
    directory, as a `RunSetup` (`a` is updated as the JAX CLI updates it:
    the architecture from --resume, modsize, samples); with --export the
    shaders and the image of the snapshot, and None."""
    device = resolve_device(a.device)
    dtype = resolve_dtype(a.precision, device)
    card_settings(device)
    gen = torch.Generator(device=device).manual_seed(a.seed)

    def seeded(seed, dev=device):
        return torch.Generator(device=dev).manual_seed(seed)

    siren = a.generator == 'siren'
    par, gen_params = build_parameterizer(a, gen)
    print(' .. %d vars, %d layers, %d nf, act %s'
          % (len(gen_params), a.layers, a.nf,
             'sine w0=%g' % a.w0 if siren else a.actfn))

    if a.export:
        if a.resume is None:
            raise ValueError('--export needs a snapshot: -r net.npy')
        print('exporting')
        base = a.resume.replace('.npy', '')
        export_all(shader_layers(a, gen_params), base, a.size, a.decim)
        with torch.no_grad():
            checkout(par.image(gen_params)[0],
                     a.resume.replace('.npy', '.jpg'))
        return None

    # ---- CLIP model(s) and the sample budget ------------------------------
    clips = [ClipWrapper(a.model, device, a.clip_weights,
                         generator=seeded(a.seed, "cpu"))]
    a.modsize = clips[0].modsize
    if a.model in XMEM_CPPN:
        a.samples = int(a.samples * XMEM_CPPN[a.model])
    if a.dualmod is not None:
        clips.append(ClipWrapper('ViT-B/16', device, a.clip_weights,
                                 generator=seeded(a.seed, "cpu")))
        a.samples = int(a.samples * 0.69)
        print(' dual model every %d step' % a.dualmod)
    mesh = setup_mesh(getattr(a, 'mesh', None), clips, a.verbose)
    a.samples = max(a.samples, 1)
    aests = [None] * len(clips)
    if a.aest != 0 and aesthetic_dims(a.model):
        aests = [aesthetic_get(seeded(7 + i), c.name, a.aest_weights)
                 for i, c in enumerate(clips)]
    transform = 'fast' if a.transform else 'none'
    if a.transform:
        a.samples = int(a.samples * 0.95)

    # ---- prompts: plain cossim, weights -1 / +0.5 / -1 ---------------------
    img_np = (img_read(a.in_img) if a.in_img is not None
              and os.path.isfile(a.in_img) else None)
    start = gen.get_state()

    def groups_for(clip):
        groups = []
        if a.in_txt is not None:
            embs, wts = clip.enc_text(maybe_translate(a.in_txt, a.translate,
                                                      a.verbose))
            groups.append((embs, wts, -1.0))
        if a.in_txt0 is not None:
            embs, wts = clip.enc_text(maybe_translate(a.in_txt0, a.translate,
                                                      a.verbose))
            groups.append((embs, wts, 0.5))
        if img_np is not None:
            # every tower encodes the same cutouts of the image
            img_gen = torch.Generator(device=device)
            img_gen.set_state(start)
            emb, _ = clip.enc_image_sliced(img_np, a.samples, a.align, img_gen)
            groups.append((emb, torch.full((emb.shape[0],), 1.0 / emb.shape[0],
                                           device=device), -1.0))
        return build_prompt_groups(groups)

    prompts = [groups_for(c) for c in clips]
    if not prompts[0]:
        raise ValueError(' Loss not defined, check the inputs')

    out_name = []
    if a.in_txt:
        out_name.append(txt_clean(a.in_txt))
    if img_np is not None:
        out_name.append(basename(a.in_img).replace(' ', '_'))
    sfx = '-l%d-n%d' % (a.layers, a.nf)
    if siren:
        sfx += '-siren'
    if a.dualmod is not None:
        sfx += '-dm%d' % a.dualmod
    if a.aest != 0:
        sfx += '-ae%.2g' % a.aest
    out_name = '-'.join(out_name) + sfx
    tempdir = os.path.join(a.out_dir, 'cppn', out_name)
    if mesh_primary():
        os.makedirs(tempdir, exist_ok=True)

    # ---- step functions ---------------------------------------------------
    sampler = CutoutSampler(tuple(a.size), a.samples, a.modsize, a.align,
                            a.macro, use_pallas=a.pallas)
    settings = StepSettings(sim='cossim', sharp=a.sharp, sharp_mode='sobel',
                            aest=a.aest, total_steps=a.steps,
                            transform=transform, persp=resolve_persp(a.persp),
                            clip_dtype=dtype)
    towers = [Tower(c.cfg, c.vision(dtype), ae, p)
              for c, ae, p in zip(clips, aests, prompts)]
    return RunSetup(par, sampler, towers, None, a.dualmod, settings,
                    build_optimizer('adam', a.lrate),
                    build_draw_fn(sampler, settings, None), gen, gen_params,
                    out_name, tempdir, mesh)


def run(a) -> RunResult | None:
    """The whole run (under --mesh, rank 0's result)."""
    return run_cli(a, _run)


def _run(a) -> RunResult | None:
    su = setup(a)
    if su is None:
        return None
    out_base = tempdir = su.tempdir
    gen_params = su.gen_params
    opt_state = su.optimizer.init(gen_params)
    prev_enc = torch.zeros((a.samples, su.clip_cfg.embed_dim),
                           device=su.gen.device)
    pbar = ProgressBar(a.steps)
    losses, seconds, loop = [], [], None
    chunked = a.fstep > 0 and a.steps % a.fstep == 0 and a.steps >= a.fstep
    primary = mesh_primary()
    with trace(a.profile), frame_writer() as writer:
        if chunked:
            n_frames = a.steps // a.fstep
            nf = frames_per_dispatch(tuple(a.size), n_frames)
            loop = build_train_loop_frames(
                su.par, su.sampler, su.clip_cfg, su.settings, su.optimizer,
                a.fstep, nf, step_index='step', with_params=True, dual=su.dual,
                mesh=su.mesh)
            for c in range(n_frames // nf):
                t0 = time.perf_counter()
                (gen_params, opt_state, prev_enc, frames, snaps,
                 dl) = loop(gen_params, opt_state, prev_enc, *su.loop_args(),
                            lambda gstep: su.draw(su.gen), c * nf)
                fnames = [os.path.join(tempdir, '%04d' % (c * nf + j))
                          for j in range(nf)]
                writer.save_batch([f + '.jpg' for f in fnames], frames)
                snaps = [s.cpu() for s in snaps]       # the dispatch's pull
                for j, fname in enumerate(fnames if primary else ()):
                    export_npy([s[j] for s in snaps], fname)
                losses += dl.tolist()
                seconds += dispatch_seconds(time.perf_counter() - t0,
                                            loop.first_runs, nf, a.fstep)
                for _ in range(nf * a.fstep):
                    pbar.upd()
        else:
            steps = [build_train_step(su.par, su.sampler, t.cfg, su.settings,
                                      su.optimizer, su.mesh)
                     for t in su.towers]
            dm_nums = dualmod_steps(a.steps, a.dualmod) if a.dualmod else set()
            render = build_render(su.par)
            for i in range(a.steps):
                t0 = time.perf_counter()
                tower = int(i in dm_nums)
                gen_params, opt_state, prev_enc, loss = steps[tower](
                    gen_params, opt_state, prev_enc, *su.consts(tower),
                    su.draw(su.gen), i)
                losses.append(loss.item())
                seconds.append(time.perf_counter() - t0)
                if i % a.fstep == 0:
                    fname = os.path.join(tempdir, '%04d' % (i // a.fstep))
                    writer.save(fname + '.jpg',
                                render(gen_params).cpu().numpy())
                    if primary:
                        export_npy(gen_params, fname)
                pbar.upd()

    # ---- the net, its shaders and the video (rank 0 of a mesh) ------------
    video = None
    if primary:
        export_npy(gen_params, out_base)
        export_all(shader_layers(a, gen_params), out_base, a.size, a.decim)
        video = frames_to_video(tempdir, out_base + '.avi')
        frames = img_list(tempdir)
        if frames:
            shutil.copy(frames[-1], out_base + '-%d.jpg' % a.steps)
    return RunResult(gen_params, losses, seconds, a.samples, out_base, video,
                     loop)


if __name__ == '__main__':
    main()
