"""The port's own measurement (aphantasia_torch/profiling.py) on the CPU:
span records, their parents per thread and sequence numbers, the ring's
eviction, the frame writer's waits and its encoder processes' spans, the clock
that puts records on the profiler's, the ranges that only `trace` opens,
the device marks (off a capture an identity that adds no node; in a
capture, at the step's layer boundaries) and the intervals they name.

The graph's own node walk and event times need the card: see
tests/test_torch_gpu.py."""
import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from aphantasia_torch import profiling
from aphantasia_torch import step as tstep
from aphantasia_torch.io.media import AsyncFrameWriter
from aphantasia_torch.kernels import CountedGraph
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler
from aphantasia_torch.params.fft import FFTParameterizer
from aphantasia_torch.profiling import collect, mark, span


def test_span_records_name_seq_parent_thread_and_time():
    with collect() as got:
        with span("outer") as outer:
            with span("inner", 3) as inner:
                time.sleep(0.001)
        with span("after"):
            pass
    assert [r.name for r in got] == ["inner", "outer", "after"]
    assert got[-1] is profiling.RECORDS[-1]
    assert inner.parent == outer.seq and outer.parent is None
    assert got[2].parent is None and outer.seq < inner.seq < got[2].seq
    assert {r.thread for r in got} == {threading.get_ident()}
    assert inner.value == 3 and outer.value is None
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert inner.seconds >= 0.001 and outer.seconds >= inner.seconds


def test_collect_blocks_nest_and_keep_their_own():
    with collect() as outer:
        with span("a"):
            pass
        with collect() as inner:
            with span("b"):
                pass
    assert [r.name for r in outer] == ["a", "b"]
    assert [r.name for r in inner] == ["b"]


def test_the_ring_evicts_the_oldest(monkeypatch):
    ring = collections.deque(maxlen=4)
    monkeypatch.setattr(profiling, "RECORDS", ring)
    for i in range(6):
        assert profiling.full() == (i >= 4)
        with span(f"s{i}"):
            pass
    assert profiling.full()
    assert [r.name for r in profiling.records()] == ["s2", "s3", "s4", "s5"]


def test_threads_keep_their_own_parents_under_contention(monkeypatch):
    """More threads than cores, each nesting spans with a short switch
    interval: every record lands in the ring once, with a sequence number
    of its own, its own thread and its own thread's parent."""
    monkeypatch.setattr(profiling, "RECORDS", collections.deque(maxlen=10**5))
    n_threads, n = 24, 300
    results, errors = {}, []

    def work(k):
        try:
            with collect() as got:
                for _ in range(n):
                    with span("outer"):
                        with span("inner"):
                            pass
            results[k] = (threading.get_ident(), got)
        except Exception as e:          # reported by the main thread
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    ring = profiling.records()
    assert len(ring) == n_threads * n * 2
    assert len({r.seq for r in ring}) == len(ring)
    for ident, got in results.values():
        assert len(got) == 2 * n and {r.thread for r in got} == {ident}
        for inner, outer in zip(got[::2], got[1::2]):
            assert (inner.name, outer.name) == ("inner", "outer")
            assert inner.parent == outer.seq and outer.parent is None


def test_writer_encodes_in_its_threads_and_waits_only_when_it_blocks(
        tmp_path):
    """One slot: a second frame admitted while the first (a large PNG)
    still encodes waits (a "writer.wait" holding the one pending frame);
    one admitted once the first is done does not; each "writer.encode" is
    the interval its encoder process sent back, recorded with that
    process's pid and no parent (the writer's close may wait for the last
    frame)."""
    start = time.perf_counter_ns()
    slow = np.random.RandomState(0).randint(0, 256, (900, 1200, 3),
                                            dtype=np.uint8)
    frame = np.zeros((8, 8, 3), np.uint8)
    with collect() as got, AsyncFrameWriter(encoders=1, slots=1) as w:
        w.save(str(tmp_path / "a.png"), slow)
        w.save(str(tmp_path / "b.png"), frame)
        w.flush()
        w.save(str(tmp_path / "c.png"), frame)
        pid = w._procs[0].pid
    admits = [r for r in got if r.name == "writer.admit"]
    waits = [r for r in got if r.name == "writer.wait"
             and r.parent in {a.seq for a in admits}]
    assert len(admits) == 3 and len(waits) == 1
    assert waits[0].parent == admits[1].seq and waits[0].value == 1
    assert waits[0].seconds > 0.01
    encodes = [r for r in profiling.records()
               if r.name == "writer.encode" and r.t0 >= start]
    assert len(encodes) == 3
    assert {r.thread for r in encodes} == {r.process for r in encodes} == {pid}
    assert all(r.parent is None for r in encodes)
    assert encodes[0].t1 <= waits[0].t1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "a.png", "b.png", "c.png"]


def test_trace_without_a_dir_is_a_no_op():
    with profiling.trace(None) as prof:
        with span("x"):
            pass
    assert prof is None


def _host_events(prof, names):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in names]


def test_trace_ranges_lie_within_their_records_on_the_profiler_clock(
        tmp_path):
    """Inside `trace(dir)` each span is a range of its name, and the range
    lies within the span's record moved by PROFILER_OFFSET_NS (20 us)."""
    names = {f"clock.{i}" for i in range(5)}
    with collect() as got, profiling.trace(str(tmp_path)) as prof:
        for i in range(5):
            with span(f"clock.{i}"):
                torch.ones(64).sum()
                time.sleep(0.002)
    events = {n: (s, e) for n, s, e in _host_events(prof, names)}
    assert set(events) == names
    off = profiling.PROFILER_OFFSET_NS
    for r in got:
        s, e = events[r.name]
        assert r.t0 + off - 20_000 <= s <= e <= r.t1 + off + 20_000, (
            r.name, s - r.t0 - off, r.t1 + off - e)
    assert list(tmp_path.iterdir())


def test_trace_file_shows_the_encoder_processes_encodes(tmp_path):
    """`trace(dir)` adds the writer's encodes, which ran in its encoder
    process, to the trace file as events of that process's pid, on the
    file's clock: each starts after the range of the admission that sent
    it began, and ends before the trace file was written."""
    import json
    frame = np.zeros((16, 16, 3), np.uint8)
    with profiling.trace(str(tmp_path)):
        with AsyncFrameWriter(encoders=1) as w:
            pid = w._procs[0].pid
            w.save(str(tmp_path / "a.jpg"), frame)
            w.save(str(tmp_path / "b.jpg"), frame)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    admits = sorted(e["ts"] for e in events
                    if e.get("name") == "writer.admit" and e.get("ph") == "X")
    encodes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("name") == "writer.encode")
    assert len(admits) == 2 and len(encodes) == 2
    assert all(e["pid"] == pid for e in events
               if e.get("name") == "writer.encode")
    assert all(a <= s < t for a, (s, t) in zip(admits, encodes))


def test_no_program_range_under_a_profiler_the_program_did_not_start():
    """A profiler outside `trace` (the benchmark's) sees no range of the
    program's spans, so none becomes a device annotation there."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("draw"), span("loop.group"):
            torch.ones(64).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::sum" in names
    assert not names & {"draw", "loop.group"}


def test_mark_off_a_capture_returns_its_input_and_adds_no_node():
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    assert mark(x, "decode") is x and mark(y, "cut") is y
    assert y.grad_fn.name() == "MulBackward0"
    pair = [x, y]
    assert mark(pair, "decode") is pair


class _Recorder:
    """A stand-in for the capturing graph: the names of its marks."""

    def __init__(self):
        self.names = []

    def add_mark(self, name):
        self.names.append(name)


TINY = tm.CLIPConfig("tiny", 16, 32, 1, 32, 16, transformer_width=32,
                     transformer_heads=2, transformer_layers=1,
                     vision_heads_override=2)


def _tiny_step():
    par = FFTParameterizer((32, 48), 1.0, 1.6)
    sampler = CutoutSampler((32, 48), 3, 32, "uniform")
    settings = tstep.StepSettings(transform="fast", noise=0.1)
    opt = to.build_optimizer("adam", 0.05)
    gen = torch.Generator().manual_seed(1)
    clip = tm.clip_init(gen, TINY)
    params = par.init(gen)
    prompts = ((torch.randn((1, 16), generator=gen), torch.ones(1),
                torch.full((), -1.0)),)
    draw = tstep.build_draw_fn(sampler, settings, tuple(params.shape))
    step = tstep.build_train_step(par, sampler, TINY, settings, opt)
    return par, opt, clip, params, prompts, draw(gen), step


def test_marks_sit_at_the_step_layer_boundaries_and_change_nothing():
    """In a capture the train step marks decode, cut, tower and loss going
    forward and each again at the end of its backward, the render its
    start and end, and the unfused tower's one block its attention core
    ("attn" before it, "tower" after it, and the same in the backward);
    the step's numbers equal an unmarked step's."""
    par, opt, clip, params, prompts, draws, step = _tiny_step()
    render = tstep.build_render(par)
    outs = []
    for rec in (None, _Recorder()):
        p = params.clone()
        st = opt.init(p)
        with (profiling.marking(rec) if rec else collect()):
            p, st, enc, loss = step(p, st, torch.zeros((3, 16)), clip, None,
                                    None, prompts, draws, 0)
            frame = render(p)
        outs.append((p, st.mu, enc, loss, frame))
    assert rec.names == ["decode", "cut", "tower", "attn", "tower", "loss",
                         "loss.bwd", "tower.bwd", "attn.bwd", "tower.bwd",
                         "cut.bwd", "decode.bwd", "render", "group"]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _autograd_names(t) -> set:
    """The names of every node in the autograd graph behind t."""
    seen, names, todo = set(), set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def test_tower_attention_marks_are_the_identity_off_a_capture():
    """Off a capture the unfused tower's "attn" and "tower" marks around
    each attention core (`mha_flat`) return their inputs and add no
    autograd node; under a capture's marking they record each layer's
    pair going forward and again in the backward, and the embedding and
    image gradient are the same."""
    cfg = tm.CLIPConfig("tiny2", 16, 32, 2, 32, 16, transformer_width=32,
                        transformer_heads=2, transformer_layers=1,
                        vision_heads_override=2)
    clip = tm.clip_init(torch.Generator().manual_seed(3), cfg)
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(4))
    outs, rec = [], _Recorder()
    for marking in (None, rec):
        xx = x.clone().requires_grad_(True)
        with (profiling.marking(marking) if marking else collect()):
            emb = tm.encode_image(clip, cfg, xx)
            names = _autograd_names(emb)
            (g,) = torch.autograd.grad(emb.square().sum(), xx)
        outs.append((emb.detach(), g, names))
    (e0, g0, n0), (e1, g1, n1) = outs
    assert "_MarkBackward" not in n0 and "_MarkBackward" in n1
    assert n1 - n0 == {"_MarkBackward"}
    assert rec.names == ["attn", "tower"] * 2 + ["tower.bwd", "attn.bwd"] * 2
    assert torch.equal(e0, e1) and torch.equal(g0, g1)


def test_interval_names_give_each_layer_its_forward_and_backward():
    names = ["decode", "cut", "tower", "loss", "loss.bwd", "tower.bwd",
             "cut.bwd", "decode.bwd", "render", "group"]
    assert profiling.interval_names(names) == [
        "decode", "cut", "tower", "loss", "tower", "cut", "decode", "step",
        "render"]


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_layer_ms_sums_each_layer_over_the_group_steps():
    """Two steps in one graph: each layer's intervals summed."""
    g = CountedGraph.__new__(CountedGraph)
    names = ["decode", "cut", "tower", "loss", "loss.bwd", "tower.bwd",
             "cut.bwd", "decode.bwd"] * 2
    g.marks = [(n, _Event(float(i * i))) for i, n in enumerate(names)]
    ms = g.layer_ms()
    t = [float(i * i) for i in range(len(names))]
    d = np.diff(t)
    assert ms["tower"] == d[2] + d[4] + d[10] + d[12]
    assert ms["decode"] == d[0] + d[6] + d[8] + d[14]
    assert ms["step"] == d[7]
    assert sum(ms.values()) == t[-1] - t[0]


@pytest.mark.parametrize("depth", [1, 2])
def test_the_loop_records_its_dispatch_groups_and_capture(depth):
    """A frame loop of two one-step groups a dispatch: a "loop.dispatch"
    around a "loop.group" a group (the first holding the "loop.capture"
    of its eager run) and a "draw" a step; first_runs holds the capture
    span's seconds."""
    par, opt, clip, params, prompts, _, _ = _tiny_step()
    sampler = CutoutSampler((32, 48), 3, 32, "uniform")
    settings = tstep.StepSettings(transform="fast")
    loop = tstep.build_train_loop_frames(par, sampler, TINY, settings, opt,
                                         1, 2)
    draw = tstep.build_draw_fn(sampler, settings, tuple(params.shape))
    gen = torch.Generator().manual_seed(2)
    state = (params, opt.init(params), torch.zeros((3, 16)))
    with collect() as got:
        for c in range(depth):
            state = loop(*state, clip, None, None, prompts,
                         lambda g: draw(gen), 2 * c)[:3]
    names = [r.name for r in got]
    assert names.count("loop.dispatch") == depth
    assert names.count("loop.group") == 2 * depth
    assert names.count("draw") == 2 * depth
    assert names.count("loop.capture") == 1
    by_seq = {r.seq: r for r in got}
    for r in got:
        if r.name == "loop.group":
            assert by_seq[r.parent].name == "loop.dispatch"
        if r.name == "loop.capture":
            assert by_seq[r.parent].name == "loop.group"
    first = next(r for r in got if r.name == "loop.capture")
    assert depth > 1 or loop.first_runs == {0: first.seconds}
