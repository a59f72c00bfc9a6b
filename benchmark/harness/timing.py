"""Device timing with CUDA events and the table of peaks (after the smoke
script's `cuda_ms`, `capture`, `graph_ms` and `bound`).

Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit):
989 TFLOP/s bf16, 495 TF32, 67 float32 outside the tensor cores, and
3.35 TB/s of HBM."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound_ms(nbytes: float, ops: float, kind: str) -> float:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the peak of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind]) * 1e3


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, from CUDA
    events around the whole run, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def capture(fn, iters: int = 1, warmup: int = 2):
    """(graph, last result): `fn` called `warmup` times on a side stream,
    then `iters` calls captured into one CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            out = fn()
    return graph, out


def graph_ms(fn, iters: int = 5, warmup: int = 2, replays: int = 3) -> float:
    """Mean device time of `fn` per call with no host work between
    launches: `iters` calls in one CUDA graph, one warm replay, then CUDA
    events around `replays` replays."""
    import torch
    graph, _ = capture(fn, iters, warmup)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms
