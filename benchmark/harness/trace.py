"""The traced segment of a `--trace 1` run: a few more dispatches after the
window under torch.profiler, read for the device's busy time (the union
of its kernels' intervals), the operations that took most time, and the
longest idle gaps with the benchmark span that was open on the host.
Where the profiler records no device time, the busy time comes from CUDA
events around each dispatch of the segment instead, and no breakdown is
given."""
from __future__ import annotations

import time

SEGMENT_S = 0.5          # the segment runs dispatches for at least this
NAME_CHARS = 160         # a kernel's name is cut to this in the breakdown


def _events(prof):
    """(kernels, host ranges): [(start_us, end_us, name)] each, from the
    profiler's raw results (or its function events).  The device copies
    of the benchmark's own ranges (`bench:*` annotations) are not
    kernels."""
    from torch.autograd import DeviceType
    kernels, ranges = [], []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            item = (start, end, e.name())
            if e.device_type() == DeviceType.CUDA:
                if not e.name().startswith("bench:"):
                    kernels.append(item)
            elif e.name().startswith("bench:"):
                ranges.append(item)
    except (AttributeError, RuntimeError):
        for e in prof.events():
            item = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith("bench:"):
                    kernels.append(item)
            elif e.name.startswith("bench:"):
                ranges.append(item)
    return kernels, ranges


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(ranges, t: float) -> str:
    """The innermost benchmark span open at host time t."""
    best = None
    for s, e, name in ranges:
        if s <= t <= e and name != "bench:segment" and (
                best is None or s >= best[0]):
            best = (s, name)
    return best[1][len("bench:"):] if best else "between spans"


def segment(run, step) -> dict:
    """Run `step()` (one dispatch) under the profiler for SEGMENT_S
    seconds; returns {busy_s, window_s, breakdown or None, source}."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    warnings.filterwarnings("ignore", message=".*clears events.*")
    torch.cuda.synchronize()
    pairs = []
    run.spans.profiling = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench:segment"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < SEGMENT_S:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                step()
                e1.record()
                pairs.append((e0, e1))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    run.spans.profiling = False
    kernels, ranges = _events(prof)
    seg = [r for r in ranges if r[2] == "bench:segment"]
    if not kernels or not seg:
        busy = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        return {"busy_s": busy, "window_s": t1 - t0, "breakdown": None,
                "source": "cuda events around each dispatch (the profiler "
                          "recorded no device time)"}
    s0, s1 = seg[0][0], seg[0][1]
    merged = _merge([(max(s, s0), min(e, s1)) for s, e, _ in kernels
                     if e > s0 and s < s1])
    busy_us = sum(e - s for s, e in merged)
    gaps = [(merged[i + 1][0] - merged[i][1],
             (merged[i][1] + merged[i + 1][0]) / 2)
            for i in range(len(merged) - 1)]
    if merged:
        gaps.append((merged[0][0] - s0, (s0 + merged[0][0]) / 2))
        gaps.append((s1 - merged[-1][1], (merged[-1][1] + s1) / 2))
    gaps.sort(reverse=True)
    by_name: dict = {}
    for s, e, name in kernels:
        if e > s0 and s < s1:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": (s1 - s0) / 1e6,
            "breakdown": {
                "device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[_label(ranges, mid), g / 1e6]
                              for g, mid in gaps[:10]]},
            "source": "torch.profiler (CUPTI), union of kernel intervals"}
