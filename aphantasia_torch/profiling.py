"""The port's own measurement: host spans in a bounded ring, timing marks
inside a captured CUDA graph, a count of a graph's nodes by type, and a
torch.profiler trace of a block (`trace`, the CLIs' `--profile DIR`).

Spans are always recorded, cheaply, in memory, so a reader outside the
program (the benchmark's per-layer metrics) finds them without turning
anything on.  A span is a `with span(name):` block; its record is the span
object itself, appended to `RECORDS` when the block ends:

    name     what the block does ("draw", "loop.group", "writer.wait", ...)
    seq      a process-wide sequence number, taken when the block starts
    parent   the seq of the span open around it in the same thread, or None
    thread   `threading.get_ident()` of the thread it ran in
    t0, t1   `time.perf_counter_ns()` at its start and end
    value    a number the block records (the writer's pending frames), or
             None

A span that ran in another process (an encoder process's "writer.encode")
is recorded by `add_record` when its interval comes back: its `thread` and
its `process` are that process's pid, its parent None.  Its times are on
the same clock, since `perf_counter_ns` reads the machine's monotonic
clock; the process's own spans have no `process`.

`RECORDS` is a deque of at most `CAPACITY` (32768) records; the oldest go
first.  A 10-s window of any benchmark cell makes under 5,000 (a still
step records about 4, a video frame about 7), so a run's set-up and window
fit with room to spare.  `PROFILER_OFFSET_NS`, taken once at import, puts
a record's times on the profiler's host clock (Kineto stamps host events
on the Unix-epoch clock): `t0 + PROFILER_OFFSET_NS` is comparable with an
event's `start_ns()`.

Inside `trace(log_dir)`, and only there, each span also opens a
`record_function` range of its name, so a `--profile` trace shows the
program's spans over the card's kernels (and the records of other
processes, added to its file as events of their pid).  Elsewhere a span
opens no range: a profiler that the program did not start (the
benchmark's) sees none.

`mark(x, name)` is an identity on a tensor that, while a
`kernels.CountedGraph` captures, records a timing event into the graph
(and another, `name + ".bwd"`, where the backward passes it).  After a
replay `CountedGraph.layer_ms()` turns the intervals between them into
device ms per layer (`interval_names`).  Off a capture a mark returns its
input and adds no autograd node.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import os
import threading
import time

import torch

CAPACITY = 32768
RECORDS: collections.deque = collections.deque(maxlen=CAPACITY)
PROFILER_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_seq = itertools.count()
_ranges = False              # True inside trace(): spans open ranges too


class _Local(threading.local):
    open = None              # the seq of the innermost open span
    sinks = ()               # the lists of the collect() blocks open


_local = _Local()


class span:
    """`with span(name[, value]):` records the block in `RECORDS` (module
    docstring); `as s` gives the record, whose `seconds` is its length
    once the block has ended."""

    __slots__ = ("name", "value", "seq", "parent", "thread", "t0", "t1",
                 "_range", "process")

    def __init__(self, name: str, value=None):
        self.name, self.value = name, value

    def __enter__(self):
        local = _local
        self.seq = next(_seq)
        self.parent = local.open
        local.open = self.seq
        self.thread = threading.get_ident()
        self._range = None
        self.t0 = time.perf_counter_ns()
        if _ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.t1 = time.perf_counter_ns()
        local = _local
        local.open = self.parent
        RECORDS.append(self)
        for sink in local.sinks:
            sink.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __repr__(self):
        return (f"span({self.name!r}, seq={self.seq}, parent={self.parent}, "
                f"{(self.t1 - self.t0) / 1e3:.1f} us)")


def add_record(name: str, t0: int, t1: int, pid: int, value=None) -> span:
    """Record a span that ran in the process `pid` from t0 to t1
    (`perf_counter_ns` there); returns the record (module docstring)."""
    rec = span(name, value)
    rec.seq, rec.parent, rec._range = next(_seq), None, None
    rec.thread = rec.process = pid
    rec.t0, rec.t1 = t0, t1
    RECORDS.append(rec)
    return rec


def records() -> list:
    """A copy of the ring, oldest first (safe while other threads
    record)."""
    return list(RECORDS)


def full() -> bool:
    """Whether the ring is at its capacity, so it may have lost records."""
    return len(RECORDS) == RECORDS.maxlen


@contextlib.contextmanager
def collect():
    """The records this thread makes inside the block, in the order they
    end, besides the ring (which may evict them in a long run); blocks
    nest, and each gets its own."""
    got: list = []
    local = _local
    outer = local.sinks
    local.sinks = outer + (got,)
    try:
        yield got
    finally:
        local.sinks = outer


# ---------------------------------------------------------------- device marks

_capturing = None            # the kernels.CountedGraph now capturing


@contextlib.contextmanager
def marking(graph):
    """Marks record into `graph` while the block runs (its capture)."""
    global _capturing
    outer, _capturing = _capturing, graph
    try:
        yield
    finally:
        _capturing = outer


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, graph):
        ctx.name, ctx.graph = name, graph
        graph.add_mark(name)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.graph.add_mark(ctx.name + ".bwd")
        return grad, None, None


def mark(x, name: str):
    """x as is; while a CountedGraph captures, a timing event `name` in the
    graph before the work that follows and, where the backward passes it,
    `name + ".bwd"` (module docstring).  A list marks its first leaf."""
    graph = _capturing
    if graph is None:
        return x
    if isinstance(x, (list, tuple)):
        return type(x)([mark(x[0], name), *x[1:]])
    return _Mark.apply(x, name, graph)


def interval_names(names) -> list:
    """The layer of each interval between consecutive marks: the layer a
    backward mark ends (its name without ".bwd"), else the layer a forward
    mark starts, else (from a backward mark to a forward one: the
    optimizer and the loop's copies) "step"."""
    out = []
    for a, b in zip(names, names[1:]):
        if b.endswith(".bwd"):
            out.append(b[:-4])
        elif not a.endswith(".bwd"):
            out.append(a)
        else:
            out.append("step")
    return out


# ---------------------------------------------------------------- graph nodes

# CUgraphNodeType (cuda.h); the runtime's cudaGraphNodeType has the same
# values
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}
_driver = None


def _cuda_driver():
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int)]
        lib.cuGraphChildGraphNodeGetGraph.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        for fn in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType,
                   lib.cuGraphChildGraphNodeGetGraph):
            fn.restype = ctypes.c_int
        _driver = lib
    return _driver


def graph_nodes(raw_graph: int) -> collections.Counter:
    """The nodes of a CUDA graph (a `cudaGraph_t`, as
    `CUDAGraph.raw_cuda_graph()` gives it) by type name, child graphs'
    nodes included, through the driver's cuGraphGetNodes."""
    lib = _cuda_driver()

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA driver error {rc}")
    out: collections.Counter = collections.Counter()
    stack = [ctypes.c_void_p(raw_graph)]
    while stack:
        g = stack.pop()
        n = ctypes.c_size_t(0)
        check(lib.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(lib.cuGraphGetNodes(g, nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            check(lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value == 4:
                child = ctypes.c_void_p()
                check(lib.cuGraphChildGraphNodeGetGraph(
                    ctypes.c_void_p(node), ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                stack.append(child)
            out[NODE_TYPES.get(kind.value, str(kind.value))] += 1
    return out


# ---------------------------------------------------------------- --profile

@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler over the block when a log dir is given, the host's
    activity and, with a CUDA device, the card's, with every span of the
    block as a range of its name; the Chrome trace is written into
    `log_dir` (`<host>_<pid>.<time>.pt.trace.json`, which TensorBoard's
    profiler plugin and chrome://tracing read).  Yields the profiler, or
    None: a no-op without a dir."""
    global _ranges
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:        # every thread's spans, where torch can
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        config = None
    handler = tensorboard_trace_handler(log_dir)
    start = time.perf_counter_ns()

    def ready(prof):
        handler(prof)
        _add_outside(log_dir, start)
    with profile(activities=acts, experimental_config=config,
                 on_trace_ready=ready) as prof:
        _ranges = True
        try:
            yield prof
        finally:
            _ranges = False


def _add_outside(log_dir: str, start: int):
    """Add the records of other processes that started after `start` to
    the newest trace file in `log_dir`, as complete events of their pid on
    the file's clock (Kineto's `ts` in us from `baseTimeNanoseconds`)."""
    import glob
    import json
    outside = [r for r in records()
               if getattr(r, "process", None) is not None and r.t0 >= start]
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if not outside or not files:
        return
    path = max(files, key=os.path.getmtime)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    doc["traceEvents"] += [
        {"ph": "X", "cat": "user_annotation", "name": r.name,
         "pid": r.process, "tid": r.process,
         "ts": (r.t0 + PROFILER_OFFSET_NS - base) / 1e3,
         "dur": (r.t1 - r.t0) / 1e3} for r in outside]
    with open(path, "w") as f:
        json.dump(doc, f)
