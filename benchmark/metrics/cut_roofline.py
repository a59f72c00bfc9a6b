"""The cutouts alone (ops/sampler.py `CutoutSampler.cut`, forward and
backward, a video cell's overscan tiling included) at the cell's frame
and cutout count, by graph replay, against the bytes they must move.
Read for `.still` and `.video` alike."""
from benchmark.harness import layers


def read(lay: dict):
    return layers.cut_roofline(lay)
