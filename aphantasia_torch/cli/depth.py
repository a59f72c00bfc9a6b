"""depth: Depth-Anything-V2 over an image or a folder of images
(counterpart of aphantasia_tpu.cli.depth).

Same flags and outputs as the JAX CLI, plus `--device`: for each image a
grayscale PNG (three equal channels) of its min-maxed inverse depth at
the image's own size, `<out_dir>/<name>.png`.  Images are grouped by
their inference size (short side at least `--size`, both sides multiples
of 14) and go through the model in batches of 4 of one shape (a short
last batch of a group is padded with its last image, when the group has
more than one batch); the upsample to the group's largest size and the
uint8 quantization run on the device, so one uint8 map an image comes
back to the host.  Runs on the CUDA device unless `--device cpu` is
given; without a GPU it raises.

    python -m aphantasia_torch.cli.depth -i photos -o _out/depth
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from aphantasia_torch.cli.common import card_settings
from aphantasia_torch.device import resolve_device
from aphantasia_torch.io.media import basename, img_list, img_read, img_save
from aphantasia_torch.ops.resize import resize_bicubic
from aphantasia_torch.progress import ProgressBar
from aphantasia_torch.weights import env_weights

ENCODERS = ["vits", "vitb", "vitl", "s", "b", "l"]

_BATCH = 4   # images a forward within a group of one shape


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Depth Anything V2")
    parser.add_argument('-i', '--input', default='_in', help='Input image or folder')
    parser.add_argument('-o', '--out_dir', default='_out')
    parser.add_argument('--encoder', default='vitb', choices=ENCODERS)
    parser.add_argument('-sz', '--size', type=int, default=768, help='inference short side (rounded to multiple of 14)')
    parser.add_argument('--depth_weights', default=None, help='DA-V2 checkpoint (HF safetensors dir/file); APHANTASIA_DAV2_PT otherwise')
    parser.add_argument('-v', '--verbose', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a GPU) or 'cpu'")
    return parser.parse_args(argv)


def infer_dims(h, w, size):
    """The inference size of an h x w image: short side at least `size`,
    both sides rounded to multiples of 14 (at least 14)."""
    scale = size / min(h, w)
    return tuple(max(14, int(round(d * scale / 14)) * 14) for d in (h, w))


def to_uint8(depth: torch.Tensor, out_hw) -> torch.Tensor:
    """[N,1,hd,wd] in [0,1] -> [N,H,W] uint8: the bicubic upsample, then
    the quantization (the upsample's overshoot clipped)."""
    up = resize_bicubic(depth, out_hw)
    return torch.clamp(up[:, 0] * 255.0, 0, 255).to(torch.uint8)


def main(argv=None) -> int:
    """Writes one PNG an image; returns the number written."""
    a = get_args(argv)
    device = resolve_device(a.device)
    card_settings(device)
    from aphantasia_torch.models.depth_anything import InferDepthAny
    from aphantasia_torch.models.depth_anything.convert import convert_hf_dav2
    os.makedirs(a.out_dir, exist_ok=True)
    dw = env_weights('dav2', a.depth_weights)
    deptha = InferDepthAny(a.encoder[-1],
                           params=convert_hf_dav2(dw) if dw else None,
                           device=device)

    paths = [a.input] if os.path.isfile(a.input) else img_list(a.input)
    if not paths:
        print(' no images found in', a.input)
        return 0
    imgs = []
    buckets = defaultdict(list)   # inference dims -> indices into imgs
    for i, path in enumerate(paths):
        img = img_read(path)
        imgs.append(img)
        buckets[infer_dims(*img.shape[:2], a.size)].append(i)
    if a.verbose:
        print(f' {len(paths)} images, {len(buckets)} shape bucket(s),'
              f' encoder {a.encoder}, size {a.size}')

    pbar = ProgressBar(len(paths))
    written = 0
    for dims, idxs in sorted(buckets.items()):
        # one padded output size a group: its images share an aspect ratio
        # up to the rounding to 14, so the padding is small
        out_h = max(imgs[i].shape[0] for i in idxs)
        out_w = max(imgs[i].shape[1] for i in idxs)
        for k in range(0, len(idxs), _BATCH):
            chunk = idxs[k:k + _BATCH]
            batch = torch.cat([resize_bicubic(
                torch.tensor(imgs[i], device=device).permute(2, 0, 1)[None]
                .float() / 255.0, dims) for i in chunk])
            if len(chunk) < _BATCH and len(idxs) > _BATCH:
                # one shape a group: the short last batch is padded
                batch = torch.cat([batch, batch[-1:].expand(
                    _BATCH - len(chunk), -1, -1, -1)])
            maps = to_uint8(deptha(batch), (out_h, out_w)).cpu().numpy()
            for j, i in enumerate(chunk):
                h, w = imgs[i].shape[:2]
                gray = maps[j, :h, :w]
                img_save(os.path.join(a.out_dir, basename(paths[i]) + '.png'),
                         np.repeat(gray[:, :, None], 3, axis=-1))
                written += 1
                pbar.upd()
    if a.verbose:
        print(' saved to', a.out_dir)
    return written


if __name__ == '__main__':
    main()
