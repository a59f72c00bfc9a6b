"""clip_vqgan: a VQGAN latent optimised against CLIP through the frozen
taming decoder (counterpart of aphantasia_tpu.cli.clip_vqgan).

Same flags, defaults and outputs as the JAX CLI: the size snapped to the
decoder's stride, a `%04d.jpg` frame every step and config.txt in
`<out_dir>/<name>-vq/`, `<name>-vq.mp4` and the last frame beside it, and
with --save_pt the latent as `<name>-vq.pt` (a bare tensor, which
`--resume` reads back).  The decoder loads from --vqgan_weights or
APHANTASIA_VQGAN_PT (a taming state dict or Lightning `.ckpt`,
`models/vqgan.convert_taming`), else it is random-init, loudly.  Prompts
weigh -1 (text and style), +1 (text to subtract) and -weight_img (image);
the sample budget is `apply_sample_budget` with the extra prompts;
optimizer `adam_custom`.  The decode runs in bf16 on the card
(APHANTASIA_DECODE_F32=1 keeps it float32) and float32 on the CPU.

Every step is a frame: `frames_per_dispatch` one-step groups a dispatch
through `build_train_loop_frames`, on the card one captured graph
replayed.  Runs on the CUDA device unless `--device cpu` is given;
without a GPU it raises.  --mesh N|NxM|dcn runs the steps over mesh
ranks (`common.run_cli`), rank 0 writing; --fleet runs the whole job on
each host, as in JAX.

    python -m aphantasia_torch.cli.clip_vqgan -t "a lighthouse"
    python -m aphantasia_torch.cli.clip_vqgan -t "a lighthouse" \\
        --vqgan gumbel_f8_8192 -s 640-512 --pallas
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
    build_prompt_groups, card_settings, dispatch_seconds,
    frame_writer, maybe_translate, parse_size, resolve_dtype, resolve_persp,
    run_cli, setup_mesh)
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.checkpoint import load_pt, save_pt
from aphantasia_torch.io.media import frames_to_video, img_list, img_read
from aphantasia_torch.models.vqgan import (VQGAN_CONFIGS, VQGANParameterizer,
                                           convert_taming, vqgan_init)
from aphantasia_torch.ops.optim import build_optimizer
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.parallel.mesh import mesh_primary
from aphantasia_torch.profiling import trace
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.step import (StepSettings, build_draw_fn,
                                   build_train_loop_frames,
                                   frames_per_dispatch)
from aphantasia_torch.utils import save_cfg, txt_clean
from aphantasia_torch.weights import env_weights, warn_random


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-t',  '--in_txt',  default=None, help='input text')
    parser.add_argument('-t2', '--in_txt2', default=None, help='style text')
    parser.add_argument('-t0', '--in_txt0', default=None, help='subtract text')
    parser.add_argument('-i',  '--in_img',  default=None, help='input image')
    parser.add_argument('-wi', '--weight_img', default=0.5, type=float)
    parser.add_argument('--out_dir', default='_out')
    parser.add_argument('-s',  '--size',    default='640-480', help='~800x600 is the practical VQGAN ceiling')
    parser.add_argument('-r',  '--resume',  default=None, help='saved latents .pt')
    parser.add_argument('--vqgan', default='imagenet_f16_16384',
                        choices=list(VQGAN_CONFIGS.keys()))
    parser.add_argument('--vqgan_weights', default=None, help='taming checkpoint')
    parser.add_argument('-m',  '--model',   default='ViT-B/32')
    parser.add_argument('--steps',   default=200, type=int)
    parser.add_argument('--samples', default=200, type=int)
    parser.add_argument('-lr', '--lrate',   default=0.1, type=float)
    parser.add_argument('-a',  '--align',   default='uniform')
    parser.add_argument('-tf', '--transform', default='fast')
    parser.add_argument('-mm', '--macro',   default=0.4, type=float)
    parser.add_argument('--sim',     default='mix')
    parser.add_argument('--save_pt', action='store_true')
    parser.add_argument('-tr', '--translate', action='store_true')
    parser.add_argument('-v',  '--verbose',    dest='verbose', action='store_true')
    parser.add_argument('-nv', '--no-verbose', dest='verbose', action='store_false')
    parser.set_defaults(verbose=True)
    parser.add_argument('--clip_weights', default=None)
    parser.add_argument('--precision', default='auto', choices=['auto', 'bf16', 'fp32'])
    parser.add_argument('--seed', default=0, type=int)
    add_parallel_flags(parser)
    a = parser.parse_args(argv)
    a.size = parse_size(a.size)
    return a


@dataclasses.dataclass
class RunResult:
    params: torch.Tensor          # the final latent [1, z, H/f, W/f]
    losses: list                  # one float per step
    step_seconds: list            # as clip_fft's RunResult
    samples: int                  # cutouts per step after the budget
    out_name: str                 # run directory / file stem under out_dir
    video: str | None             # the video written, if any
    loop: object = None           # the run's FrameLoop
    par: object = None            # the VQGANParameterizer


def main(argv=None):
    run(get_args(argv))


def setup(a) -> RunSetup:
    """The run's decoder, tower, prompts, start latent and step pieces and
    its run directory with config.txt, as a `RunSetup` (`a` is updated as
    the JAX CLI updates it: size, samples)."""
    device = resolve_device(a.device)
    dtype = resolve_dtype(a.precision, device)
    card_settings(device)
    gen = torch.Generator(device=device).manual_seed(a.seed)
    cfg_v = VQGAN_CONFIGS[a.vqgan]
    a.size = [s - s % cfg_v.f for s in a.size]    # the decoder's stride

    vq_path = env_weights('vqgan', a.vqgan_weights)
    if vq_path:
        dec_params = convert_taming(vq_path, cfg_v, device)
    else:
        warn_random('vqgan decoder')
        dec_params = vqgan_init(torch.Generator(device=device).manual_seed(
            a.seed + 3), cfg_v)
    par = VQGANParameterizer(tuple(a.size), cfg_v, dec_params)

    clip1 = ClipWrapper(a.model, device, a.clip_weights,
                        generator=torch.Generator().manual_seed(a.seed))
    mesh = setup_mesh(getattr(a, 'mesh', None), (clip1,), a.verbose)
    a.samples = apply_sample_budget(
        a.samples, a.model, None, 0, 0, a.transform,
        (a.in_txt2 is not None) + (a.in_txt0 is not None))

    groups, out_name = [], []
    for txt, coeff, tag in ((a.in_txt, -1.0, ''), (a.in_txt2, -1.0, ''),
                            (a.in_txt0, 1.0, 'off-')):
        if txt is None:
            continue
        txt = maybe_translate(txt, a.translate, a.verbose)
        embs, wts = clip1.enc_text(txt)
        groups.append((embs, wts, coeff))
        out_name.append(tag + txt_clean(txt).lower()[:40])
    if a.in_img is not None and os.path.isfile(a.in_img):
        emb, _ = clip1.enc_image_sliced(img_read(a.in_img), a.samples,
                                        a.align, gen)
        groups.append((emb, torch.full((emb.shape[0],), 1.0 / emb.shape[0],
                                       device=device), -a.weight_img))
        out_name.append(os.path.splitext(os.path.basename(a.in_img))[0])
    if not groups:
        raise ValueError(' Loss not defined, check the inputs')

    if a.resume is not None:
        z = load_pt(a.resume)
        if isinstance(z, list):
            z = z[0]
        gen_params = torch.as_tensor(np.asarray(z, np.float32), device=device)
    else:
        gen_params = par.init(gen)

    sampler = CutoutSampler(tuple(a.size), a.samples, clip1.modsize, a.align,
                            a.macro, use_pallas=a.pallas)
    settings = StepSettings(sim=a.sim or 'cossim', total_steps=a.steps,
                            transform=a.transform,
                            persp=resolve_persp(a.persp), clip_dtype=dtype)
    out_name = ('-'.join(out_name) or 'vqgan') + '-vq'
    tempdir = os.path.join(a.out_dir, out_name)
    if mesh_primary():
        os.makedirs(tempdir, exist_ok=True)
        save_cfg(a, tempdir, 'config.txt')
    tower = Tower(clip1.cfg, clip1.vision(dtype), None,
                  build_prompt_groups(groups))
    return RunSetup(par, sampler, [tower], None, None, settings,
                    build_optimizer('adam_custom', a.lrate),
                    build_draw_fn(sampler, settings, None), gen, gen_params,
                    out_name, tempdir, mesh)


def run(a) -> RunResult:
    """The whole run (under --mesh, rank 0's result)."""
    return run_cli(a, _run)


def _run(a) -> RunResult:
    su = setup(a)
    gen_params, out_name, tempdir = su.gen_params, su.out_name, su.tempdir
    opt_state = su.optimizer.init(gen_params)
    prev_enc = torch.zeros((a.samples, su.clip_cfg.embed_dim),
                           device=su.gen.device)
    pbar = ProgressBar(a.steps) if a.verbose else None
    # every step renders a frame: one-step groups, nf a dispatch
    nf = frames_per_dispatch(tuple(a.size), a.steps)
    loop = build_train_loop_frames(su.par, su.sampler, su.clip_cfg,
                                   su.settings, su.optimizer, 1, nf,
                                   mesh=su.mesh)
    losses, seconds = [], []
    with trace(a.profile), frame_writer() as writer:
        for c in range(a.steps // nf):
            t0 = time.perf_counter()
            gen_params, opt_state, prev_enc, frames, dl = loop(
                gen_params, opt_state, prev_enc, *su.loop_args(),
                lambda gstep: su.draw(su.gen), c * nf)
            writer.save_batch([os.path.join(tempdir, '%04d.jpg' % (c * nf + j))
                               for j in range(nf)], frames)
            losses += dl.tolist()
            seconds += dispatch_seconds(time.perf_counter() - t0,
                                        loop.first_runs, nf, 1)
            for _ in range(nf if pbar is not None else 0):
                pbar.upd()

    video = None
    if mesh_primary():
        video = frames_to_video(tempdir,
                                os.path.join(a.out_dir, out_name + '.mp4'))
        frames = img_list(tempdir)
        if frames:
            shutil.copy(frames[-1], os.path.join(
                a.out_dir, '%s-%d.jpg' % (out_name, a.steps)))
        if a.save_pt:
            save_pt('%s.pt' % os.path.join(a.out_dir, out_name), gen_params)
    return RunResult(gen_params, losses, seconds, a.samples, out_name, video,
                     loop, su.par)


if __name__ == '__main__':
    main()
