"""The video cell (`illustrip`): the CLI's own `setup`, its `frame_steps()`,
`scene()`, `frame()` and `draw`, frame by frame into the frame writer, as
the CLI's `_run` drives them (its loop body mirrored here: the CLI does
not expose it).  The traffic's scene lines are written to a text file
that the CLI reads as a user's.

After each frame's dispatch a CUDA event is recorded; the events are
read after the window, so the window never waits for the device except
where the program does.  The window ends with the first frame
dispatched at or after `seconds`, once the device has finished it."""
from __future__ import annotations

import dataclasses
import os
import time

from benchmark.harness import check

WARM_FRAMES = 4          # frame 0 captures, frame 1 is the first replay


@dataclasses.dataclass
class State:
    a: object
    su: object
    fss: list
    writer: object
    params: object = None
    opt: object = None
    prev: object = None
    num: int = 0
    ii: int = 0
    sched: object = None
    frames: int = 0
    losses: list = dataclasses.field(default_factory=list)
    done: list = dataclasses.field(default_factory=list)
    prep: list = dataclasses.field(default_factory=list)
    pairs: list = dataclasses.field(default_factory=list)
    snaps: dict = dataclasses.field(default_factory=dict)
    window: tuple = (0.0, 0.0, 0)


def setup(run) -> State:
    import torch
    from aphantasia_torch.cli import illustrip
    from aphantasia_torch.cli.common import frame_writer
    tr = run.cell.traffic
    scenes = os.path.join(run.tmp, "scenes.txt")
    with open(scenes, "w") as f:
        f.write("\n".join(tr["scenes"]) + "\n")
    with run.spans("setup.cli"):
        a = illustrip.get_args(list(tr["flags"]) + [
            "-t", scenes, "--out_dir", run.tmp, "--seed", str(run.cli_seed),
            "-nv", "--device", run.device,
            "--clip_weights", run.weights["clip"]])
        su = illustrip.setup(a)
    if su.depth_helpers() is not None:
        raise ValueError("this driver runs no depth warp")
    st = State(a, su, su.frame_steps(), frame_writer().__enter__())
    st.params = su.params
    st.opt = su.optimizer.init(st.params)
    st.prev = torch.zeros((a.samples, su.towers[0][0].embed_dim),
                          device=su.device)
    st.sched = su.scene(0)
    st.snaps = {"p0": st.params.clone(), "draws": [], "motion": [],
                "losses": [], "cli_seed": run.cli_seed}
    with run.spans("setup.warmup"):
        for _ in range(WARM_FRAMES):
            frame(run, st)
    st.snaps["losses"] = [float(x[0]) for x in st.losses[:3]]
    if run.cuda:
        torch.cuda.synchronize()
    return st


def frame(run, st, pair: bool = False) -> None:
    """One frame, as `_run`'s loop body."""
    import torch
    a, su = st.a, st.su
    if st.ii == a.steps:
        st.num, st.ii = st.num + 1, 0
        with run.spans("scene"):
            st.sched = su.scene(st.num)
    t0 = time.perf_counter()
    if pair:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
    with run.spans("frame_prep"):
        tower, prompts, motion = su.frame(st.sched, st.num, st.ii)
        draws = [su.draw(su.gen) for _ in range(a.opt_step)]
    st.prep.append(time.perf_counter() - t0)
    with run.spans("dispatch"):
        st.params, st.opt, st.prev, img, losses = st.fss[tower](
            st.params, st.opt, st.prev, su.towers[tower][1],
            su.towers[tower][2], prompts, draws, st.ii, motion)
    if run.cuda:
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        st.done.append(done)
    k = st.frames
    if k < 3:
        st.snaps["draws"].append(check.still_draws(check.plain(draws[0])))
        st.snaps["motion"].append((motion[0], (motion[1], motion[2]),
                                   motion[3], motion[4]))
        if k == check.PROBE - 1:
            st.snaps["before"] = st.params.clone()
        elif k == check.PROBE:
            st.snaps["grad"] = st.opt.mu.clone()
            st.snaps["enc"] = st.prev.clone()
            st.snaps["state"] = st.params.clone()
            st.snaps["frame"] = img.clone()
        elif k == 2:
            st.snaps["p3"] = st.params.clone()
    with run.spans("writer_admit"):
        st.writer.save_batch([os.path.join(
            su.tempdir, "%06d.jpg" % (st.num * a.steps + st.ii))], img[None])
    if pair:
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        st.pairs.append((e0, e1))
    st.losses.append(losses)
    st.ii += 1
    st.frames += 1


def window(run, st, seconds: float) -> dict:
    import torch
    n0, p0 = st.frames, len(st.prep)
    start = None
    if run.cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    while True:
        frame(run, st, pair=run.trace and run.cuda)
        if time.perf_counter() - t0 >= seconds:
            break
    if run.cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = st.frames - n0
    st.window = (t0, t1, n)
    st.window_prep = st.prep[p0:]
    out = {"frames_per_min": n / (t1 - t0) * 60.0, "attempted": n}
    if run.cuda:
        evs = [start] + st.done[-n:]
        gaps = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
        from benchmark.harness.core import percentile
        out["frame_p95_ms"] = percentile(gaps, 95.0)
    st.losses = [x.tolist() for x in st.losses]
    return out


def layer(run, st) -> dict:
    t0, t1, frames = st.window
    su = st.su
    (group,) = [g for fs in st.fss for g in fs.groups.values()]
    return {"kind": "video", "config": run.cell.config,
            "settings": run.cell.traffic["settings"],
            "cutouts": st.a.samples, "dtype": su.settings.clip_dtype,
            "size": tuple(st.a.size), "steps": frames * st.a.opt_step,
            "frames": frames, "window_s": t1 - t0,
            "graphs": [group.graph], "steps_per_graph": st.a.opt_step,
            "tower_cfg": su.towers[0][0], "tower_vis": su.towers[0][1],
            "sampler": su.sampler, "boxes": su.draw(su.gen).cuts.boxes,
            "prep_s": st.window_prep, "pairs": st.pairs}


def step(run, st):
    return lambda: frame(run, st)


def release(run, st) -> dict:
    st.writer.__exit__(None, None, None)
    snaps = st.snaps
    st.__dict__.clear()
    return snaps


def lines(run) -> list:
    return list(run.cell.traffic["scenes"])
