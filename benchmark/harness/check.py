"""The comparison that decides `correct`.

The set-up drives the window's own loop object from the seed through its
first steps (or frames), through the window's own call and feed, and
keeps: each draw the feed produced, the start state, each step's loss,
the third step's state, and around the probe step, the first that
replays the captured graph as the window does (step 0 runs eagerly and
captures): the state before it, the gradient as the optimiser holds it
after it (b1 = 0: its first moment is the last gradient), the cutouts'
embeddings, the state after it and the frame it rendered.  After the
window the plain reference (benchmark/reference) follows the same three
steps from its own start state and its own weights, and takes the probe
step again from the program's state before it, so that the probe's
numbers see that step's arithmetic and not the trajectory's drift (the
start is compared by itself, the three steps by their change).  Each
number is compared against its limit in benchmark/limits/<workload>.json:

  loss0_gap   |L - L_ref| / |L_ref| of the first step's loss
  loss_gap    the largest |L - L_ref| / |L_ref| over the three losses
  start_gap   the largest |p0 - p0_ref|: the start state, drawn from the
              seed on both sides
  embed_gap   the median over the probe step's cutouts of
              |e - e_ref| / |e_ref|, e the tower's embedding of a cutout
              (the loop keeps the last step's embeddings for the next)
  embed_max   the largest of those
  grad_gap    | |g| - |g_ref| | / |g_ref| of the probe step's gradient
  grad_dir    |g - g_ref| / |g_ref| of the same: its direction as well
  half_skew   how far g leans to one half of the cutouts: g fitted by
              least squares as a g_A + b g_B, g_A and g_B the reference's
              gradients with the similarity's means over the first and
              the second half of the cutouts (g_ref = w_A g_A + w_B g_B,
              w the halves' shares); |a / w_A - b / w_B| / 2, 0 for the
              whole batch and about 1 for one half alone
  change_gap  | |p3 - p0| - |p3_ref - p0_ref| | / |p3_ref - p0_ref| over
              each side's own three steps
  frame_mean  the mean level by which the probe step's frame differs from
              the reference's render of the program's state after it
  frame_gap   the largest such level
  draws_bad   draws outside their distributions' ranges (limit 0)

The control and the faults are compared the same way, each from its own
states.  The state is one tensor (a spectrum, a latent or the pixels), so
the worst leaf is that leaf.  A number with no limit in the file is
printed and not compared."""
from __future__ import annotations

import torch

from benchmark.reference import follow as R

PROBE = 1                # the first step that replays the captured graph


def plain(obj):
    """A draw structure (named tuples of tensors) as plain tuples of
    clones, for the reference."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    return tuple(plain(v) for v in obj)


def still_draws(step_draws) -> tuple:
    """The reference's part of a CLI step draw: ((csize, offx, offy),
    (endpoints, rot_idx, erasing))."""
    shift, cuts, cuts2 = step_draws
    if shift is not None or cuts2 is not None:
        raise ValueError("the reference follows no spectrum noise and no "
                         "second cutout pass")
    boxes, aug = cuts
    return (tuple(boxes), tuple(aug))


def draws_bad(draws, settings: dict) -> int:
    """Draws outside what their distributions can give: boxes larger than
    the frame or smaller than the least crop (the tower's input, or a
    macro crop's 0.9 of the frame's shorter side), or outside the padded
    frame; rotation indices outside the table; erasing areas outside
    [0.02, 0.33]; perspective corners outside the cutout."""
    h, w = settings["size"]
    hp, wp = settings["padded"]
    m = settings["modsize"]
    least = min(m, int(0.9 * min(h, w)))
    bad = 0
    for (csize, offx, offy), (end, rot, erasing) in draws:
        bad += int(((csize < least) | (csize > min(h, w))).sum())
        bad += int(((offx < 0) | (offx > wp - csize)).sum())
        bad += int(((offy < 0) | (offy > hp - csize)).sum())
        bad += int(((rot < 0) | (rot >= 80)).sum())
        area = erasing[1]
        bad += int(((area < 0.02 - 1e-6) | (area > 0.33 + 1e-6)).sum())
        bad += int(((end < 0) | (end > m - 1)).sum())
    return bad


def _skew(g, ga, gb, wa: float, wb: float) -> float:
    """|a / wa - b / wb| / 2 of the least-squares fit g = a ga + b gb."""
    ga, gb, g = (t.flatten().double() for t in (ga, gb, g))
    gram = torch.stack([torch.stack([ga @ ga, ga @ gb]),
                        torch.stack([gb @ ga, gb @ gb])])
    a, b = torch.linalg.solve(gram, torch.stack([ga @ g, gb @ g])).tolist()
    return abs(a / wa - b / wb) / 2.0


def numbers(side: dict, ref: dict, notes: dict | None = None) -> dict:
    """The compared numbers of one side (the program's snapshots, or the
    control's or a fault's trajectory) against the reference `ref`
    (`reference_run`): its trajectory, and its probe step taken at the
    side's own state before that step.  `notes`, where given, receives
    the reference probe's gradient norm and how far its halves' gradients
    lie apart, relative to it."""
    problem, traj, k = ref["problem"], ref["traj"], PROBE
    gaps = [abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(side["losses"], traj["losses"])]
    inputs = (side["before"], ref["draws"][k], ref["groups"][k],
              None if ref["motion"] is None else ref["motion"][k])
    _, gr, er = R.probe(problem, *inputs)
    n = er.shape[0]
    _, ga, _ = R.probe(problem, *inputs, rows=slice(0, n // 2))
    _, gb, _ = R.probe(problem, *inputs, rows=slice(n // 2, n))
    g, gr = side["grad"].float(), gr.float()
    grad_gap = float((g.norm() - gr.norm()).abs() / gr.norm())
    grad_dir = float((g - gr).norm() / gr.norm())
    half_skew = _skew(g, ga, gb, (n // 2) / n, (n - n // 2) / n)
    if notes is not None:
        notes.update(grad_norm_ref=float(gr.norm()),
                     halves_apart=float((ga - gb).norm() / gr.norm()))
    dp = (side["p3"] - side["p0"]).float().norm()
    dr = (traj["states"][2] - ref["p0"]).float().norm()
    change_gap = float((dp - dr).abs() / dr)
    err = (side["enc"].float() - er).norm(dim=-1) / er.norm(dim=-1)
    frame = problem.render(side["state"])
    levels = (side["frame"].int() - frame.int()).abs()
    return {"loss0_gap": gaps[0], "loss_gap": max(gaps),
            "start_gap": float((side["p0"] - ref["p0"]).abs().max()),
            "embed_gap": float(err.median()), "embed_max": float(err.max()),
            "grad_gap": grad_gap, "grad_dir": grad_dir,
            "half_skew": half_skew, "change_gap": change_gap,
            "frame_mean": float(levels.float().mean()),
            "frame_gap": int(levels.max())}


def judge(values: dict, limits: dict) -> dict:
    """{name: {value, limit, ok}}; a number without a limit is shown with
    limit None and does not decide."""
    out = {}
    for name, value in values.items():
        limit = limits.get(name)
        ok = True if limit is None else value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def groups_for(problem, settings: dict, lines: list, frame: int) -> list:
    """The prompt groups of a step: a still cell's one prompt (sign -1);
    a video frame's crossfade from scene line 0 to line 1 over the
    scene's frames."""
    if settings["kind"] != "rgb":
        embs, wts = problem.prompt(lines[0])
        return [(embs, wts, -1.0)]
    n = settings["scene_frames"]
    e1, w1 = problem.prompt(lines[0])
    e2, w2 = problem.prompt(lines[1])
    return [(e1, w1 * (n - frame) / n, -1.0), (e2, w2 * frame / n, -1.0)]


def reference_run(config, settings, paths, device, snaps, lines, prec=None,
                  half=None) -> dict:
    """The reference's problem, start state and trajectory over the
    snapshots' draws and motion, with those inputs."""
    kw = {} if prec is None else {"prec": prec}
    problem = R.Problem(config, settings, paths, device, half=half, **kw)
    p0 = problem.init(snaps["cli_seed"])
    groups = [groups_for(problem, settings, lines, k) for k in range(3)]
    motion = snaps.get("motion")
    traj = R.follow(problem, p0, snaps["draws"], groups, motion)
    return {"problem": problem, "p0": p0, "traj": traj,
            "draws": snaps["draws"], "groups": groups, "motion": motion}


def side_of(ref: dict) -> dict:
    """A reference-style trajectory (the control's, a fault's) as a
    compared side."""
    traj = ref["traj"]
    return {"losses": traj["losses"], "grad": traj["grads"][PROBE],
            "enc": traj["encs"][PROBE], "p0": ref["p0"],
            "before": traj["states"][PROBE - 1],
            "state": traj["states"][PROBE], "p3": traj["states"][2],
            "frame": traj["frames"][PROBE]}


def compare(config, settings, paths, device, snaps, lines, limits) -> tuple:
    """(compared dict, notes) of the program's snapshots against the
    reference."""
    ref = reference_run(config, settings, paths, device, snaps, lines)
    values = numbers(snaps, ref)
    values["draws_bad"] = draws_bad(snaps["draws"], settings)
    notes = {"losses": snaps["losses"], "losses_ref": ref["traj"]["losses"]}
    return judge(values, limits), notes
