"""Device ms a step of the image tower inside the replayed step: its
forward and backward between the program's "tower" and "loss" marks
(models/clip/model.py through `encode_image`), from the cell's captured
graph (`CountedGraph.layer_ms`, 10 replays).  Read for `.still` and
`.video` alike."""
from benchmark.harness import spans


def read(lay: dict):
    ms = spans.layer_ms(lay)
    return None if ms is None or "tower" not in ms else ms["tower"]
