"""Finding a cell's pieces by name, the run's environment, host spans, the
import guard and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found from the names in
`BENCHMARK.json`:

    benchmark/configs/<file named by the configuration entry>
    benchmark/traffic/<traffic>.json      (names its driver)
    benchmark/drivers/<driver>.py
    benchmark/metrics/<metric>.py         (a per-layer metric's reader; a
                                           metric `<base>.<part>` with no
                                           file of its own shares
                                           metrics/<base>.py)
    benchmark/limits/<workload>.json      (the output comparison's limits)

so a later change adds a cell, a mix or a metric as new files and entries.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "aphantasia_tpu")


def process_start() -> float:
    """The process's start on the `time.time()` clock, from /proc (clock
    ticks since boot); the current time where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])          # field 22 of stat, starttime
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules=None) -> list:
    """The entries of `sys.modules` whose top-level name (the part before
    the first dot) is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A benchmark file (driver or metric reader) as a module, by path:
    its name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "_bench_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic,
    driver, limits and metric lists, each found by name."""

    def __init__(self, workload: str, manifest: dict | None = None,
                 bench_dir: str = BENCH_DIR):
        self.bench_dir = bench_dir
        repo = os.path.dirname(bench_dir)
        self.manifest = manifest if manifest is not None else load_json(
            os.path.join(repo, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the manifest "
                             f"has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(repo, self.config_entry["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(self.path("traffic", self.traffic_name
                                           + ".json"))
        self.driver_path = self.path("drivers",
                                     self.traffic["driver"] + ".py")
        limits = self.path("limits", workload + ".json")
        self.limits = load_json(limits) if os.path.isfile(limits) else {}

    def path(self, *parts) -> str:
        return os.path.join(self.bench_dir, *parts)

    def driver(self):
        return load_module(self.driver_path, self.traffic["driver"])

    def _listed(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> list:
        return [m for m in self.manifest["end_to_end"] if self._listed(m)]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if self._listed(m) and m["moves"] in e2e]

    def reader(self, metric: str):
        """metrics/<metric>.py, else the reader of the part before the
        first dot, which the metric's variants share."""
        path = self.path("metrics", metric + ".py")
        if not os.path.isfile(path):
            path = self.path("metrics", metric.split(".", 1)[0] + ".py")
        return load_module(path, metric)


def run_environment(repo: str = REPO) -> None:
    """The run's environment: every build and kernel cache of the program
    at a fixed path inside the checkout (the program's own CUDA kernels
    build into build/kernels there by themselves), no switch of the
    program's left over from the caller, and no JAX behind a library."""
    cache = os.path.join(repo, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    for var in [v for v in os.environ if v.startswith("APHANTASIA_")]:
        del os.environ[var]
    os.environ["APHANTASIA_QUIET"] = "1"
    os.environ["USE_FLAX"] = "0"


class Spans:
    """Host spans from the benchmark's own files around each call into a
    layer: (name, start, end) on `time.perf_counter`.  While a profiler
    runs, each span is also a `record_function` range, so a device gap can
    be labelled by the span that was open on the host."""

    def __init__(self):
        self.items: list = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            import torch
            with torch.profiler.record_function("bench:" + name):
                yield
        else:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def summary(self, since: float = -math.inf) -> dict:
        """Per span name: count, total and mean seconds of the spans that
        start at or after `since`."""
        out: dict = {}
        for name, t0, t1 in self.items:
            if t0 < since:
                continue
            n, tot = out.get(name, (0, 0.0))
            out[name] = (n + 1, tot + t1 - t0)
        return {k: {"count": n, "total_s": tot, "mean_ms": 1e3 * tot / n}
                for k, (n, tot) in sorted(out.items())}


def percentile(values, p: float) -> float:
    """The p-th percentile of `values`, linear between order statistics
    (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    k = (len(v) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def note(*args) -> None:
    """An earlier line of the run's standard output."""
    print(*args, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, compared: dict, breakdown=None) -> str:
    """The contract's one JSON object; the numbers compared, each beside
    its limit, under the key that comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


def compared_lines(compared: dict) -> list:
    """The numbers compared as plain lines for standard error."""
    return [f"{k}: {v['value']!r} limit {v['limit']!r}"
            f"{'' if v['ok'] else '  OVER'}" for k, v in compared.items()]
