"""Device ms a step of the decode inside the replayed step: the params'
decode into the frame, forward and backward (params/fft.py,
params/pixel.py, models/vqgan.py), between the program's "decode" and
"cut" marks, and the frame's render (`build_render`), from the cell's
captured graph (`CountedGraph.layer_ms`, 10 replays).  Read for `.still`
and `.video` alike."""
from benchmark.harness import spans


def read(lay: dict):
    ms = spans.layer_ms(lay)
    if ms is None or "decode" not in ms:
        return None
    return ms["decode"] + ms.get("render", 0.0)
