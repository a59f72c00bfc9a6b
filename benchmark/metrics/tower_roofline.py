"""The image tower alone (models/clip/model.py through `encode_image` and
its autograd) on the cell's cutout batch, by graph replay, against its
bound.  Read for `.still` and `.video` alike."""
from benchmark.harness import layers


def read(lay: dict):
    return layers.tower_roofline(lay)
