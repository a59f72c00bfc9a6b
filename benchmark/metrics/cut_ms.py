"""Device ms a step of the cutouts and their augmentation inside the
replayed step, forward and backward, between the program's "cut" and
"tower" marks (ops/sampler.py, ops/augs.py), from the cell's captured
graph (`CountedGraph.layer_ms`, 10 replays).  Read for `.still` and
`.video` alike."""
from benchmark.harness import spans


def read(lay: dict):
    ms = spans.layer_ms(lay)
    return None if ms is None or "cut" not in ms else ms["cut"]
