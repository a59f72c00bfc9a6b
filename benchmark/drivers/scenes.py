"""Scene cells (`illustra`): the CLI's own `get_args` and `setup`, then
scene 0 started as the CLI's `_run` starts it (`su.start(0)`, the
optimiser's init, `su.consts(0)` and the draws of the scene's own
generator) and trained dispatch by dispatch through
`SceneLoop.dispatch`, the method `SceneLoop.scene` calls for each of a
scene's dispatches: its frames into `frame_writer().save_batch`, its
losses read inside the program's "loss_read" span.  The traffic's scene
lines are written to a text file that the CLI reads as a user's.

Set-up runs dispatches until the comparison's first steps have gone
through (the first dispatch runs a group eagerly and captures it, and
replays it for every later step: the comparison's probe step is the
first replay).  The window then starts, and ends at the end of the first
dispatch that finishes at or after `seconds`, or at scene 0's last
dispatch, whichever comes first: it never crosses a scene boundary.
The snapshots are those of the still driver; `cli_seed` is the seed of
scene 0's spectrum generator, so that the reference draws the same
start."""
from __future__ import annotations

import dataclasses
import os
import time

from benchmark.harness import check

WARM_STEPS = 4           # the comparison reads the state after step 3


@dataclasses.dataclass
class State:
    a: object
    su: object
    writer: object
    consts: object
    gen: object
    tempdir: str
    params: object = None
    opt: object = None
    prev: object = None
    steps: int = 0
    dispatches: int = 0
    losses: list = dataclasses.field(default_factory=list)
    snaps: dict = dataclasses.field(default_factory=dict)
    pairs: list = dataclasses.field(default_factory=list)
    window: tuple = (0.0, 0.0, 0)


def setup(run) -> State:
    import torch
    from aphantasia_torch.cli import illustra
    from aphantasia_torch.cli.common import frame_writer
    tr = run.cell.traffic
    scenes = os.path.join(run.tmp, "scenes.txt")
    with open(scenes, "w") as f:
        f.write("\n".join(tr["scenes"]) + "\n")
    with run.spans("setup.cli"):
        a = illustra.get_args(list(tr["flags"]) + [
            "-t", scenes, "--out_dir", run.tmp, "--seed", str(run.cli_seed),
            "-nv", "--device", run.device,
            "--clip_weights", run.weights["clip"]])
        su = illustra.setup(a)
    sl = su.scenes
    if not sl.chunked:
        raise ValueError("this driver runs the chunked scene loop")
    cli_seed = illustra.scene_generator(a.seed, 0, 1, su.device).initial_seed()
    tempdir = os.path.join(run.tmp, su.out_name(0))
    os.makedirs(tempdir, exist_ok=True)
    st = State(a, su, frame_writer().__enter__(), su.consts(0),
               illustra.scene_generator(a.seed, 0, 0, su.device), tempdir)
    st.params = su.start(0)
    st.opt = sl.optimizer.init(st.params)
    st.prev = torch.zeros((sl.sampler.count, sl.cfgs[0].embed_dim),
                          device=su.device)
    st.snaps = {"p0": st.params.clone(), "draws": [], "cli_seed": cli_seed}
    with run.spans("setup.warmup"):
        while st.steps < WARM_STEPS:
            dispatch(run, st)
    st.snaps["losses"] = st.losses[:3]
    if run.cuda:
        torch.cuda.synchronize()
    return st


def _feed(run, st):
    """The CLI's feed, `su.draw(gen)` on the scene's generator, keeping
    what the comparison reads as the first steps go through."""
    su, snaps = st.su, st.snaps

    def feed(gstep):
        with run.spans("draw"):
            d = su.draw(st.gen)
        if gstep < 3:
            snaps["draws"].append(check.still_draws(check.plain(d)))
        if gstep == check.PROBE:
            snaps["before"] = st.params.clone()
        elif gstep == check.PROBE + 1:
            snaps["grad"] = st.opt.mu.clone()
            snaps["enc"] = st.prev.clone()
            snaps["state"] = st.params.clone()
        elif gstep == 3:
            snaps["p3"] = st.params.clone()
        return d
    return feed


def dispatch(run, st, pair: bool = False) -> None:
    """The next dispatch of scene 0 through `SceneLoop.dispatch`, its
    frames into the writer as the CLI's `_run` hands them."""
    import torch
    sl = st.su.scenes
    c = st.dispatches
    e0 = None
    if pair:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()

    def save(first, frames):
        if first <= check.PROBE < first + len(frames):
            st.snaps["frame"] = frames[check.PROBE - first].clone()
        names = [os.path.join(st.tempdir, "%04d.jpg" % f)
                 for f in range(first, first + len(frames))]
        with run.spans("writer_admit"):
            st.writer.save_batch(names, frames)
        if e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            st.pairs.append((e0, e1))
    with run.spans("dispatch"):
        st.params, st.opt, st.prev, dl = sl.dispatch(
            c, st.params, st.opt, st.prev, st.consts, _feed(run, st), save)
    st.losses += dl
    st.dispatches += 1
    st.steps += sl.nf * sl.save_step


def window(run, st, seconds: float) -> dict:
    steps0 = st.steps
    last = st.su.scenes.dispatches
    t0 = time.perf_counter()
    while True:
        dispatch(run, st, pair=run.trace and run.cuda)
        if (time.perf_counter() - t0 >= seconds
                or st.dispatches == last):
            break
    t1 = time.perf_counter()
    st.window = (t0, t1, st.steps - steps0)
    return {"steps_per_s": (st.steps - steps0) / (t1 - t0),
            "attempted": st.steps - steps0}


def layer(run, st) -> dict:
    """What the per-layer readers read: the still driver's keys."""
    t0, t1, steps = st.window
    su, sl = st.su, st.su.scenes
    groups = sl.loop_for(st.consts).groups.values()
    return {"kind": "still", "config": run.cell.config,
            "settings": run.cell.traffic["settings"],
            "cutouts": st.a.samples, "dtype": sl.settings.clip_dtype,
            "size": tuple(st.a.size), "steps": steps, "window_s": t1 - t0,
            "graphs": [g.graph for g in groups],
            "steps_per_graph": sl.save_step, "tower_cfg": sl.cfgs[0],
            "tower_vis": su.vis[0], "sampler": sl.sampler, "par": sl.par,
            "boxes": su.draw(st.gen).cuts.boxes, "pairs": st.pairs}


def step(run, st):
    """One more dispatch, for the traced segment."""
    return lambda: dispatch(run, st)


def release(run, st) -> dict:
    """Close the writer (it waits for the frames it holds) and drop the
    program's state; the snapshots stay."""
    st.writer.__exit__(None, None, None)
    snaps = st.snaps
    st.__dict__.clear()
    return snaps


def lines(run) -> list:
    return list(run.cell.traffic["scenes"])
