"""Device ms a frame of the video cell's captured frame graph (step.py
`FrameStep`/`FrameGroup`, ops/warp.py): CUDA events around back-to-back
replays, over the frame's steps (one)."""
from benchmark.harness import layers


def read(lay: dict):
    return layers.graph_step_ms(lay)
