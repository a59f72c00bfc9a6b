#!/usr/bin/env python3
"""Readings that the output comparison's limits are set from, on the card
at a cell's own size, in one process:

  program  the program's numbers against the reference on each seed: its
           set-up drives the window's loop through its first steps, as a
           run's set-up does (no measured window: this is training);
  control    the reference put in the program's place one precision
             down (its bf16 parts in fp8, its float32 parts in bf16);
  half_cuts  the fault "half of the batch left out, the mean over the
             rest": the reference on the first half of the cutouts;
  half_loss  the same fault where every cutout is embedded and the
             loss's means take the first half's embeddings alone.

The fault "a step that returns its state unchanged" reads change_gap = 1
by the measure itself and needs no run.  Each seed's readings are one
JSON line in `--out`; the last line sums them up: per number the largest
program reading, and the least control and fault readings.

    python3 benchmark/control.py --workload clip_fft.b32.720p \\
        --seeds 101,102,103 --control 3 --out build/control.jsonl
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.harness import core  # noqa: E402


def readings(cell, seed: int, control: bool, device: str = "cuda") -> dict:
    """One seed's program numbers and, with `control`, the control's and
    the half-batch faults'."""
    import torch
    from benchmark.harness import check, weights
    from benchmark.reference.precision import CONTROL, float32_mode
    from benchmark.run import Run
    tmp = tempfile.mkdtemp(prefix="bench-control-",
                           dir=tempfile.gettempdir())
    try:
        run = Run(cell, seed, False, device, tmp)
        run.weights = weights.write_weights(cell.config, seed % 2 ** 63, tmp,
                                            device)
        driver = cell.driver()
        t0 = time.perf_counter()
        snaps = driver.release(run, driver.setup(run))
        setup_s = time.perf_counter() - t0
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        float32_mode()
        args = (cell.config, cell.traffic["settings"], run.weights, device,
                snaps, driver.lines(run))
        ref = check.reference_run(*args)
        look: dict = {}
        prog = check.numbers(snaps, ref, look)
        prog["draws_bad"] = check.draws_bad(snaps["draws"],
                                            cell.traffic["settings"])
        out = {"seed": seed, "setup_s": setup_s, "program": prog,
               "look": look,
               "losses": snaps["losses"],
               "losses_ref": ref["traj"]["losses"]}
        if control:
            side = check.side_of(check.reference_run(*args, prec=CONTROL))
            out["control"] = check.numbers(side, ref)
            for half in ("cuts", "loss"):
                side = check.side_of(check.reference_run(*args, half=half))
                out["half_" + half] = check.numbers(side, ref)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def summary(rows: list) -> dict:
    """Per number: the largest program reading, the least control and
    fault readings."""
    out: dict = {}
    for key, pick in (("program", max), ("control", min), ("half_cuts", min),
                      ("half_loss", min)):
        vals = [r[key] for r in rows if key in r]
        if vals:
            out[key] = {k: pick(v[k] for v in vals) for k in vals[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds for the program's readings")
    p.add_argument("--control", type=int, default=3,
                   help="read the control and the faults on the first N seeds")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    core.run_environment()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload)
    rows = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            row = dict(readings(cell, seed, i < args.control),
                       workload=args.workload)
            rows.append(row)
            f.write(json.dumps(row) + "\n")
            f.flush()
            core.note(json.dumps(row))
        total = {"workload": args.workload, "summary": summary(rows)}
        f.write(json.dumps(total) + "\n")
    core.note(json.dumps(total))
    return 0


if __name__ == "__main__":
    sys.exit(main())
