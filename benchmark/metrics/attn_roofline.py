"""The flat attention core's share of the card's bf16 peak inside the
replayed step: the operations its forward and input gradient require
(`attn_step_ops`) over `attn_ms` (the "attn" intervals of the cell's
captured graph) and 989 TFLOP/s.  None where `attn_ms` finds nothing.

A layer's core on one cutout of t tokens and width d (all heads) is
4 t^2 d forward (the scores q k^T and the values p v, 2 t^2 d each) and
8 t^2 d backward (dv = p^T do, dp = do v^T, dq = ds k, dk = ds^T q), so
12 t^2 d.  The count leaves out what a kernel computes again (its
backward's recomputed scores), so the share reads the same work
whatever implements it."""
from benchmark.harness import spans, timing


def attn_step_ops(vision: dict, cutouts: int) -> float:
    """The operations of the attention cores' forward and input gradient
    over a step's cutouts: 12 t^2 d a layer and cutout."""
    d = vision["width"]
    g = vision["image_resolution"] // vision["patch_size"]
    t = g * g + 1
    return 12.0 * t * t * d * vision["layers"] * cutouts


def read(lay: dict):
    ms = spans.layer_ms(lay)
    if ms is None or not ms.get("attn"):
        return None
    ops = attn_step_ops(lay["config"]["vision"], lay["cutouts"])
    return 100.0 * ops / (ms["attn"] * 1e-3 * timing.PEAK_OPS["bf16"])
