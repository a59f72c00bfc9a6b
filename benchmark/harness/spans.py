"""What the readers of the program's own records share: its host spans
(`aphantasia_torch.profiling.RECORDS`), the window found in them, and the
device ms by layer of the cell's captured graph
(`kernels.CountedGraph.layer_ms`).

The window is found in the program's records, not the benchmark's: the
last `steps / steps_per_graph` "loop.group" spans of a still cell, or the
last `frames` "frame.step" spans of a video cell, as the layer dict
counts them; it starts where the first of them starts its "loop.dispatch"
(still) or its frame's "frame.plan" (video) and lasts the window's
seconds, so the draw that the driver's `layer` makes after the window is
left out.  Where the program keeps no such records (an older program),
or its ring no longer holds the window's start, each function returns
None."""
from __future__ import annotations


def program_records():
    """(records oldest first, whether the ring is full), or None where the
    program records no spans."""
    try:
        from aphantasia_torch import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records") or not hasattr(profiling, "full"):
        return None
    return profiling.records(), profiling.full()


def _lost(recs, full: bool, t_ns: int) -> bool:
    """Whether a full ring may have dropped records that end after t_ns
    (it drops the oldest, in the order they ended)."""
    return full and (not recs or recs[0].t1 > t_ns)


def window(lay: dict, recs: list, full: bool):
    """(start, end) of the window on the records' clock (ns), or None."""
    if lay.get("kind") == "video":
        n, name = lay.get("frames", 0), "frame.step"
    else:
        n = lay.get("steps", 0) // max(lay.get("steps_per_graph", 1), 1)
        name = "loop.group"
    units = [r for r in recs if r.name == name]
    if n <= 0 or len(units) < n:
        return None
    first = units[-n]
    if name == "loop.group":
        opener = [r for r in recs if r.seq == first.parent
                  and r.name == "loop.dispatch"]
    else:
        opener = [r for r in recs if r.name == "frame.plan"
                  and r.thread == first.thread and r.t1 <= first.t0][-1:]
    if not opener or _lost(recs, full, opener[0].t0):
        return None
    start = opener[0].t0
    return start, start + int(round(lay["window_s"] * 1e9))


def window_ms(lay: dict, names, per: str):
    """The summed ms of the spans named in `names` that start inside the
    window, over the window's `per` ("steps" or "frames"); None where
    there is no window."""
    got = program_records()
    if got is None:
        return None
    recs, full = got
    win = window(lay, recs, full)
    if win is None or not lay.get(per):
        return None
    t0, t1 = win
    ns = sum(r.t1 - r.t0 for r in recs
             if r.name in names and t0 <= r.t0 < t1)
    return ns / 1e6 / lay[per]


def total_s(name: str):
    """The summed seconds of every span `name` of the run, or None where
    there is none or a full ring may have dropped some."""
    got = program_records()
    if got is None:
        return None
    recs, full = got
    if full:
        return None
    found = [r for r in recs if r.name == name]
    if not found:
        return None
    return sum(r.t1 - r.t0 for r in found) / 1e9


def layer_ms(lay: dict, replays: int = 10):
    """Device ms a step by layer of the cell's one captured graph: its
    marks' intervals after each of `replays` replays (each synchronised),
    averaged, over the graph's steps; None where the graph keeps no
    marks."""
    graphs = lay.get("graphs", [])
    if len(graphs) != 1:
        return None
    graph = graphs[0]
    if not getattr(graph, "marks", None) or not hasattr(graph, "layer_ms"):
        return None
    import torch
    graph.replay()
    torch.cuda.synchronize()
    total: dict = {}
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        for name, ms in graph.layer_ms().items():
            total[name] = total.get(name, 0.0) + ms
    per = replays * lay["steps_per_graph"]
    return {name: ms / per for name, ms in total.items()}
