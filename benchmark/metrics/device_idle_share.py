"""The device's idle share over the cell's traced window: 1 minus the
CUDA event pairs' elapsed times around each dispatch (a video frame's
prompts, draws, dispatch and writer admission), over the window.  Read
for `.still` and `.video` alike."""
from benchmark.harness import layers


def read(lay: dict):
    return layers.idle_share(lay)
