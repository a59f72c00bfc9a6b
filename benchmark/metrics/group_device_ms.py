"""Device ms a step of the still cell's captured frame group (step.py
`FrameLoop`/`StepGroup`, `kernels.CountedGraph`): CUDA events around
back-to-back replays of the group's graph, over its steps."""
from benchmark.harness import layers


def read(lay: dict):
    return layers.graph_step_ms(lay)
