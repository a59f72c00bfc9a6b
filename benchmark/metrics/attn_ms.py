"""Device ms a step of the flat attention core inside the replayed step,
forward and backward, over the tower's layers: the intervals between the
program's "attn" and "tower" marks around `attention_core_flat` in
models/clip/model.py `mha_flat` (the unfused vision blocks), from the
cell's captured graph (`CountedGraph.layer_ms`, 10 replays).  None where
the program keeps no such marks (the fused blocks, an older program)."""
from benchmark.harness import spans


def read(lay: dict):
    ms = spans.layer_ms(lay)
    return None if ms is None or "attn" not in ms else ms["attn"]
