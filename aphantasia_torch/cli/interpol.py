"""interpol: a crossfade video through a directory of FFT snapshots
(counterpart of aphantasia_tpu.cli.interpol).

Reads the `.pt` spectra of `--in_dir` (bare tensors, or lists whose first
item is the spectrum, as clip_fft --save_pt and illustra write them), takes
the frame size from the first one's shape, renders `--steps` frames from
each snapshot towards the next (the last towards the first) through the
decode's spectrum shift, `%05d.jpg` into `<out_dir>/a`, and assembles them
into `<in_dir>-pts.mp4`.  Runs on the CUDA device unless `--device cpu` is
given; without a GPU it raises.  --fleet R/W (or APHANTASIA_FLEET) renders
the transitions from snapshots R, R+W, ... on this host, after removing
its own frames of an earlier run, and rank 0 assembles the video once
every frame is in, waiting up to APHANTASIA_FLEET_WAIT seconds.

    python -m aphantasia_torch.cli.interpol -i _out/fft -o _out/pts
"""
from __future__ import annotations

import argparse
import os
import time

from aphantasia_torch.cli.common import FLEET_HELP, crossfade, read_pt
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.media import file_list, frames_to_video
from aphantasia_torch.params.fft import FFTParameterizer
from aphantasia_torch.parallel.multihost import init_fleet, shard_scenes


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-i', '--in_dir', default='pt')
    parser.add_argument('-o', '--out_dir', default='_out')
    parser.add_argument('-l', '--length', default=None, type=int, help='Total length in sec')
    parser.add_argument('-s', '--steps', default=25, type=int, help='Frames per transition')
    parser.add_argument('--fps', default=25, type=int)
    parser.add_argument('--contrast', default=1.1, type=float)
    parser.add_argument('--colors', default=1.8, type=float)
    parser.add_argument('-d', '--decay', default=1.5, type=float)
    parser.add_argument('-v', '--verbose', default=True, type=bool)
    parser.add_argument('--fleet', default=None, help=FLEET_HELP)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a GPU) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the video written (None when no muxer could write one)."""
    a = get_args(argv)
    rank, world = init_fleet(a.fleet)
    device = resolve_device(a.device)
    tempdir = os.path.join(a.out_dir, 'a')
    os.makedirs(tempdir, exist_ok=True)

    ptfiles = file_list(a.in_dir, 'pt')
    if not ptfiles:
        raise FileNotFoundError(f"no .pt snapshots in {a.in_dir}")
    ptest = read_pt(ptfiles[0], 'cpu')
    h, w = ptest.shape[2], (ptest.shape[3] - 1) * 2
    par = FFTParameterizer((h, w), a.decay, a.colors)
    vsteps = (a.steps if a.length is None
              else int(a.length * a.fps / len(ptfiles)))
    # the fleet's share: one transition per host, round robin
    pairs = shard_scenes(len(ptfiles), rank, world)
    if world > 1:
        # this rank's frames of an earlier run in the shared directory
        # (the pairs are disjoint, so no rank removes another's)
        for px in pairs:
            for j in range(vsteps):
                stale = os.path.join(tempdir, '%05d.jpg' % (px * vsteps + j))
                if os.path.exists(stale):
                    os.remove(stale)
    crossfade(par, a.contrast, ptfiles, vsteps, tempdir, device, a.verbose,
              pairs)
    if world > 1 and not _all_frames_in(tempdir, len(ptfiles), vsteps, rank):
        return None
    out = frames_to_video(tempdir, '%s-pts.mp4' % a.in_dir.rstrip('/'),
                          pattern='%05d.jpg', fps=a.fps)
    if out and a.verbose:
        print('\n', out)
    return out


def _all_frames_in(tempdir: str, count: int, vsteps: int, rank: int) -> bool:
    """On fleet rank 0: whether this run's every frame (by its exact name)
    is in `tempdir`, polled for up to APHANTASIA_FLEET_WAIT seconds (other
    ranks: False)."""
    if rank != 0:
        return False
    names = [os.path.join(tempdir, '%05d.jpg' % i)
             for i in range(count * vsteps)]
    deadline = time.monotonic() + float(
        os.environ.get('APHANTASIA_FLEET_WAIT', '0'))
    while True:
        n = sum(os.path.exists(f) for f in names)
        if n == len(names):
            return True
        if time.monotonic() >= deadline:
            print(' fleet: %d/%d frames present: rerun on one host to '
                  'assemble' % (n, len(names)))
            return False
        time.sleep(2.0)


if __name__ == '__main__':
    main()
