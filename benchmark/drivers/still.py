"""Still cells (`clip_fft`, `clip_vqgan`): the CLI's own `setup`, then the
`FrameLoop` of `step.build_train_loop_frames` dispatch by dispatch as the
CLI's `_run` drives it: the feed `su.draw(su.gen)`, the frames handed to
`frame_writer().save_batch`, the losses read once a dispatch.  The few
lines of `_run`'s loop body are mirrored here, not called: the CLI does
not expose them.

Set-up runs dispatches until the comparison's first steps have gone
through the window's own call and feed (the first dispatch runs a group
eagerly and captures it, and replays it for every later step: the
comparison's probe step is the first replay); the window then starts and
ends at the end of the first dispatch that finishes at or after
`seconds`."""
from __future__ import annotations

import dataclasses
import importlib
import os
import time

from benchmark.harness import check

WARM_STEPS = 4           # the comparison reads the state after step 3


@dataclasses.dataclass
class State:
    a: object
    su: object
    loop: object
    nf: int
    opt_step: int
    writer: object
    params: object = None
    opt: object = None
    prev: object = None
    steps: int = 0
    dispatches: int = 0
    losses: list = dataclasses.field(default_factory=list)
    snaps: dict = dataclasses.field(default_factory=dict)
    pairs: list = dataclasses.field(default_factory=list)
    window: tuple = (0.0, 0.0, 0)


def argv(run) -> list:
    tr = run.cell.traffic
    out = list(tr["flags"]) + [
        "-t", tr["prompt"], "--out_dir", run.tmp, "--seed",
        str(run.cli_seed), "-nv", "--device", run.device,
        "--clip_weights", run.weights["clip"]]
    if "vqgan" in run.weights:
        out += ["--vqgan_weights", run.weights["vqgan"]]
    return out


def setup(run) -> State:
    import torch
    from aphantasia_torch.cli.common import frame_writer
    from aphantasia_torch.step import (build_train_loop_frames,
                                       frames_per_dispatch)
    cli = importlib.import_module("aphantasia_torch.cli."
                                  + run.cell.traffic["cli"])
    with run.spans("setup.cli"):
        a = cli.get_args(argv(run))
        su = cli.setup(a)
    opt_step = getattr(a, "opt_step", 1)
    if opt_step != 1:
        raise ValueError("the comparison follows one step a frame")
    nf = frames_per_dispatch(tuple(a.size), a.steps // opt_step)
    loop = build_train_loop_frames(
        su.par, su.sampler, su.clip_cfg, su.settings, su.optimizer, opt_step,
        nf, contrast=getattr(a, "contrast", 1.0), dual=su.dual, mesh=su.mesh)
    st = State(a, su, loop, nf, opt_step, frame_writer().__enter__())
    st.params = su.gen_params
    st.opt = su.optimizer.init(st.params)
    st.prev = torch.zeros((a.samples, su.clip_cfg.embed_dim),
                          device=su.gen.device)
    st.snaps = {"p0": st.params.clone(), "draws": [],
                "cli_seed": run.cli_seed}
    with run.spans("setup.warmup"):
        while st.steps < WARM_STEPS:
            dispatch(run, st)
    st.snaps["losses"] = st.losses[:3]
    if run.cuda:
        torch.cuda.synchronize()
    return st


def _feed(run, st):
    """The CLI's feed, `su.draw(su.gen)`, keeping what the comparison
    reads as the first steps go through."""
    su, snaps = st.su, st.snaps

    def feed(gstep):
        with run.spans("draw"):
            d = su.draw(su.gen)
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
    """One dispatch of `nf` frame groups, as `_run`'s loop body."""
    import torch
    c, nf = st.dispatches, st.nf
    if pair:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
    with run.spans("dispatch"):
        st.params, st.opt, st.prev, frames, dl = st.loop(
            st.params, st.opt, st.prev, *st.su.loop_args(), _feed(run, st),
            c * nf)
    if c * nf <= check.PROBE < (c + 1) * nf:
        st.snaps["frame"] = frames[check.PROBE - c * nf].clone()
    with run.spans("writer_admit"):
        st.writer.save_batch([os.path.join(st.su.tempdir, "%04d.jpg" % f)
                              for f in range(c * nf, (c + 1) * nf)], frames)
    if pair:
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        st.pairs.append((e0, e1))
    with run.spans("loss_read"):
        st.losses += dl.tolist()
    st.dispatches += 1
    st.steps += nf * st.opt_step


def window(run, st, seconds: float) -> dict:
    steps0 = st.steps
    t0 = time.perf_counter()
    while True:
        dispatch(run, st, pair=run.trace and run.cuda)
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    st.window = (t0, t1, st.steps - steps0)
    return {"steps_per_s": (st.steps - steps0) / (t1 - t0),
            "attempted": st.steps - steps0}


def layer(run, st) -> dict:
    """What the per-layer readers read."""
    t0, t1, steps = st.window
    su = st.su
    return {"kind": "still", "config": run.cell.config,
            "settings": run.cell.traffic["settings"],
            "cutouts": st.a.samples, "dtype": su.settings.clip_dtype,
            "size": tuple(st.a.size), "steps": steps, "window_s": t1 - t0,
            "graphs": [g.graph for g in st.loop.groups.values()],
            "steps_per_graph": st.opt_step, "tower_cfg": su.clip_cfg,
            "tower_vis": su.towers[0].vis,
            "sampler": su.sampler, "par": su.par,
            "boxes": su.draw(su.gen).cuts.boxes, "pairs": st.pairs}


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
    return [run.cell.traffic["prompt"]]
