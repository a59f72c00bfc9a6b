"""Tracing and profiling (counterpart of aphantasia_tpu.profiling): a
torch.profiler trace of a block, and per-phase wall timers that
aggregate into a report."""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimers:
    """Accumulating wall-clock timers: `with timers.phase('decode'): ...`"""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"  {name:24s} {t:8.3f}s total  {t / n * 1000:8.2f} ms/call  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler over the block when a log dir is given, the host's
    activity and, with a CUDA device, the card's; the Chrome trace is
    written into `log_dir` (`<host>_<pid>.<time>.pt.trace.json`, which
    TensorBoard's profiler plugin and chrome://tracing read).  A no-op
    without a dir."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
