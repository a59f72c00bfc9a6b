#!/usr/bin/env python3
"""The benchmark of aphantasia_torch, the PyTorch and CUDA port: one run of
one cell of BENCHMARK.json on the CUDA card this process is started on.

    python3 benchmark/run.py --workload clip_fft.b32.720p --seed 7 \\
        --seconds 20 --trace 0

A run makes the cell's weights from the seed and writes them under
$TMPDIR in the layouts users load, drives the CLI's own set-up and loop
(benchmark/drivers), measures for `--seconds` after a warm-up that
builds and captures everything the window uses, then checks the outputs
against the plain reference (benchmark/reference) and prints, as its last
line, one JSON object: `correct`, `attempted`, `failed`, `metrics`
(with `--trace 0` the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics), `device` and, traced, `breakdown`; the numbers
compared, each with its limit, come last there and end standard error.

It exits non-zero with no result where there is no CUDA card, where the
program is missing, and where JAX, jaxlib, flax or the JAX package were
loaded in this process."""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.harness import core  # noqa: E402


class Run:
    """One run's settings, its host spans and its weight files."""

    def __init__(self, cell, seed: int, trace: bool, device: str, tmp: str):
        self.cell, self.seed = cell, seed
        self.cli_seed = seed % 2 ** 31       # the CLIs' --seed and generators
        self.trace, self.device, self.tmp = trace, device, tmp
        self.cuda = device == "cuda"
        self.spans = core.Spans()
        self.weights: dict = {}


def card_line() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            start: float) -> tuple:
    """(result dict, compared dict, notes) of one run; the caller prints."""
    import torch
    from benchmark.harness import check, trace as tracing, weights
    from benchmark.reference.precision import float32_mode
    tmp = tempfile.mkdtemp(prefix="bench-", dir=tempfile.gettempdir())
    run = Run(cell, seed, trace, device, tmp)
    notes: dict = {}
    metrics: dict = {}
    seg = None
    try:
        if run.cuda:
            torch.cuda.reset_peak_memory_stats()
        with run.spans("setup.weights"):
            run.weights = weights.write_weights(cell.config, seed % 2 ** 63,
                                                tmp, device)
        driver = cell.driver()
        st = driver.setup(run)
        setup_s = time.time() - start
        cpu0 = os.times()
        stats = driver.window(run, st, seconds)
        cpu1 = os.times()
        notes["window_cpu_s"] = {"user": cpu1.user - cpu0.user,
                                 "system": cpu1.system - cpu0.system}
        notes["window_spans"] = run.spans.summary(since=st.window[0])
        peak = torch.cuda.max_memory_allocated() if run.cuda else 0
        e2e = {"setup_s": setup_s, "peak_mem_mib": peak / 2 ** 20}
        e2e.update({k: v for k, v in stats.items() if k != "attempted"})
        units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"]
                 + cell.manifest["per_layer"]}
        if not trace:
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end() if m["name"] in e2e}
        elif run.cuda:
            lay = driver.layer(run, st)
            for m in cell.per_layer():
                value = cell.reader(m["name"]).read(lay)
                if value is not None:
                    metrics[m["name"]] = {"value": value,
                                          "unit": units[m["name"]]}
            seg = tracing.segment(run, driver.step(run, st))
            notes["spans"] = run.spans.summary()
            notes["busy_source"] = seg["source"]
        notes["end_to_end"] = e2e
        snaps = driver.release(run, st)
        del st
        gc.collect()
        if run.cuda:
            torch.cuda.empty_cache()
        float32_mode()
        t_ref = time.perf_counter()
        compared, notes["reference"] = check.compare(
            cell.config, cell.traffic["settings"], run.weights, device, snaps,
            driver.lines(run), cell.limits)
        notes["reference_s"] = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    device_info = {"platform": "gpu" if run.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if run.cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if seg is not None:
        device_info["busy_s"] = seg["busy_s"]
        device_info["window_s"] = seg["window_s"]
        breakdown = seg["breakdown"]
    correct = bool(cell.limits) and all(v["ok"] for v in compared.values())
    result = {"correct": correct, "attempted": stats["attempted"],
              "failed": 0, "metrics": metrics, "device": device_info,
              "breakdown": breakdown}
    return result, compared, notes


def main(argv=None) -> int:
    start = core.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    core.run_environment()
    cell = core.Cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    core.note("card:", card_line())
    result, compared, notes = execute(cell, args.seed, args.seconds,
                                      bool(args.trace), "cuda", start)
    found = core.forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found), file=sys.stderr)
        return 3
    for key, value in notes.items():
        core.note(f"{key}: {json.dumps(value)}")
    if args.trace and result["breakdown"] is None:
        core.note("breakdown: not given,", notes.get("busy_source"))
    lines = core.compared_lines(compared)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(core.result_line(result["correct"], result["attempted"],
                           result["failed"], result["metrics"],
                           result["device"], compared,
                           result["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
