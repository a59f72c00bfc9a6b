"""The readers of the program's own records (benchmark/harness/spans.py and
the metrics that use it) on synthetic spans, graphs and layer dicts: the
window they pick, the draw that the driver makes after it, a ring that no
longer holds the window's start, and a program that keeps no such
records (the parent of the change that added them)."""
from __future__ import annotations

import collections
import types

import pytest
import torch

from aphantasia_torch import profiling
from benchmark.harness import core, spans

MS = 1_000_000


def _cell_reader(name):
    return core.Cell("clip_fft.b32.720p").reader(name)


class _Ring:
    """Synthetic spans in the order they end, on a ring of `maxlen`."""

    def __init__(self, maxlen=1000):
        self.items = collections.deque(maxlen=maxlen)
        self.seq = 0

    def add(self, name, t0, t1, parent=None, thread=1, value=None):
        self.seq += 1
        rec = types.SimpleNamespace(name=name, seq=self.seq, parent=parent,
                                    thread=thread, t0=t0, t1=t1, value=value)
        self.items.append(rec)
        return rec

    def dispatch(self, t, groups=2, draw_ms=1, wait_ms=0):
        """A still dispatch at t ms: a draw and a group a step, then the
        writer's admit (with a wait): 10 ms a group."""
        seq0 = self.seq + 1
        self.seq += 1           # the dispatch's own seq, taken at its start
        for g in range(groups):
            s = t + 10 * g
            self.add("draw", s * MS, (s + draw_ms) * MS, parent=seq0)
            self.add("loop.group", (s + 2) * MS, (s + 9) * MS, parent=seq0)
        end = t + 10 * groups
        rec = types.SimpleNamespace(name="loop.dispatch", seq=seq0,
                                    parent=None, thread=1, t0=t * MS,
                                    t1=end * MS, value=None)
        self.items.append(rec)
        admit = self.add("writer.admit", end * MS, (end + 1 + wait_ms) * MS)
        if wait_ms:
            self.add("writer.wait", (end + 0.5) * MS,
                     (end + 0.5 + wait_ms) * MS, parent=admit.seq, value=8)
        return end + 2 + wait_ms


@pytest.fixture
def ring(monkeypatch):
    r = _Ring()
    monkeypatch.setattr(profiling, "RECORDS", r.items)
    return r


def _still(ring, window_dispatches=3, wait_ms=0):
    ring.add("setup.clip", 0, 1500 * MS)
    ring.add("setup.clip", 1600 * MS, 1700 * MS)
    t = 2000
    for _ in range(2):                      # warm-up: slower draws
        t = ring.dispatch(t, draw_ms=5)
    start = t
    for _ in range(window_dispatches):
        t = ring.dispatch(t, draw_ms=1, wait_ms=wait_ms)
    ring.add("draw", (t + 5) * MS, (t + 9) * MS)    # the driver's `layer`
    return {"kind": "still", "steps": 2 * window_dispatches,
            "steps_per_graph": 1, "window_s": (t - start) / 1e3}


def test_still_window_starts_at_its_first_dispatch(ring):
    lay = _still(ring)
    recs, full = spans.program_records()
    start, end = spans.window(lay, recs, full)
    first = [r for r in recs if r.name == "loop.dispatch"][2]
    assert start == first.t0 and end == first.t0 + 3 * 22 * MS


def test_draw_ms_reads_the_window_and_not_the_draw_after_it(ring):
    lay = _still(ring)
    assert _cell_reader("draw_ms.still").read(lay) == pytest.approx(1.0)


def test_writer_wait_ms_a_step_and_zero_where_nothing_waits(ring):
    lay = _still(ring, wait_ms=3)
    reader = _cell_reader("writer_wait_ms.still")
    assert reader.read(lay) == pytest.approx(3 * 3 / 6)
    ring.items.clear()
    assert reader.read(_still(ring)) == 0.0


def test_setup_clip_s_sums_the_clip_loads(ring):
    _still(ring)
    assert _cell_reader("setup_clip_s").read({}) == pytest.approx(1.6)


def test_a_ring_that_lost_the_window_start_reads_none(monkeypatch):
    r = _Ring(maxlen=12)
    monkeypatch.setattr(profiling, "RECORDS", r.items)
    lay = _still(r)
    assert len(r.items) == 12 and profiling.full()
    for name in ("draw_ms.still", "writer_wait_ms.still", "setup_clip_s"):
        assert _cell_reader(name).read(lay) is None
    r2 = _Ring(maxlen=20)         # full, from the last admit before it
    monkeypatch.setattr(profiling, "RECORDS", r2.items)
    lay = _still(r2)
    assert profiling.full()
    assert _cell_reader("draw_ms.still").read(lay) == pytest.approx(1.0)
    assert _cell_reader("setup_clip_s").read(lay) is None


def _video(ring, frames=4):
    t, start = 1000, None
    for k in range(6):
        if k == 6 - frames:
            start = t
        ring.add("frame.plan", t * MS, (t + 2) * MS)
        ring.add("draw", (t + 2) * MS, (t + 5) * MS)
        ring.add("frame.step", (t + 5) * MS, (t + 8) * MS)
        ring.add("writer.admit", (t + 8) * MS, (t + 9) * MS)
        t += 20
    ring.add("draw", (t + 1) * MS, (t + 4) * MS)    # the driver's `layer`
    return {"kind": "video", "frames": frames, "steps": frames,
            "steps_per_graph": 1, "window_s": (t - 11 - start) / 1e3}


def test_frame_prep_ms_reads_plan_and_draws_of_the_window_frames(ring):
    lay = _video(ring)
    recs, full = spans.program_records()
    start, _ = spans.window(lay, recs, full)
    assert start == [r for r in recs if r.name == "frame.plan"][2].t0
    assert core.Cell("illustrip.b32.rgb.720p").reader(
        "frame_prep_ms.video").read(lay) == pytest.approx(5.0)
    assert core.Cell("illustrip.b32.rgb.720p").reader(
        "writer_wait_ms.video").read(lay) == 0.0


def test_a_window_longer_than_the_records_reads_none(ring):
    lay = _video(ring)
    lay["frames"] = 7
    assert spans.window_ms(lay, ("draw",), "frames") is None


class _Graph:
    """A captured graph's stand-in: its marks' ms a replay and its node
    counts."""

    def __init__(self, ms, nodes):
        self.ms, self.nodes = ms, collections.Counter(nodes)
        self.marks = [("decode", None)]
        self.replays = 0

    def replay(self):
        self.replays += 1

    def layer_ms(self):
        return dict(self.ms)


def test_device_readers_average_the_replays_over_the_steps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = _Graph({"decode": 6.0, "render": 2.0, "cut": 4.0, "tower": 20.0,
                "loss": 1.0, "step": 3.0}, {"kernel": 2400, "memset": 3})
    lay = {"graphs": [g], "steps_per_graph": 2}
    got = {n: _cell_reader(n + ".still").read(lay)
           for n in ("tower_ms", "cut_ms", "decode_ms", "kernels_per_step")}
    assert got == {"tower_ms": 10.0, "cut_ms": 2.0, "decode_ms": 4.0,
                   "kernels_per_step": 1200}
    assert isinstance(got["kernels_per_step"], int)
    assert g.replays == 3 * 11


def test_a_program_without_records_marks_or_nodes_reads_none(monkeypatch):
    """The parent program: its graphs keep no marks or node counts and its
    profiling module no ring; every new reader returns None."""
    parent_graph = types.SimpleNamespace(replay=lambda: None)
    lay = {"graphs": [parent_graph], "steps_per_graph": 1, "kind": "still",
           "steps": 4, "window_s": 1.0}
    monkeypatch.delattr(profiling, "records")
    for name in ("tower_ms.still", "cut_ms.still", "decode_ms.still",
                 "kernels_per_step.still", "draw_ms.still",
                 "writer_wait_ms.still", "setup_clip_s"):
        assert _cell_reader(name).read(lay) is None, name
