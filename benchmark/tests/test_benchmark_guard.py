"""The import guard on whole top-level names, the reference's imports, and
the shape of the result line."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark.harness import core

REFERENCE = os.path.join(core.BENCH_DIR, "reference")


def test_guard_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "aphantasia_tpu", "aphantasia_tpu.cli.common",
            "jaxtyping", "aphantasia_torch", "aphantasia_torch.step",
            "aphantasia_tpu_extra", "flaxen", "numpy"]
    assert core.forbidden_modules(mods) == [
        "aphantasia_tpu", "aphantasia_tpu.cli.common", "flax.linen", "jax",
        "jax.numpy", "jaxlib.xla_client"]
    assert core.forbidden_modules(["aphantasia_torch.cli"]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "."
            elif node.module:
                yield node.module.split(".")[0]


def _files(top):
    for root, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in _files(REFERENCE):
        names = set(_imports(path))
        assert not names & {"aphantasia_torch", "aphantasia_tpu", "jax",
                            "jaxlib", "flax", "benchmark"}, path
        assert names <= {".", "__future__", "torch", "numpy", "math",
                         "hashlib", "html", "re", "dataclasses"}, (path, names)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _files(core.BENCH_DIR):
        names = set(_imports(path))
        assert not names & {"aphantasia_tpu", "jax", "jaxlib", "flax"}, path


def test_a_run_process_loads_no_jax():
    """The drivers' program modules, loaded in a fresh process as a run
    loads them, bring in no module that the guard refuses."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness import core\n"
            "core.run_environment()\n"
            "import benchmark.run, benchmark.control\n"
            "from benchmark.harness import check, layers, trace, weights\n"
            "import aphantasia_torch.cli.clip_fft, aphantasia_torch.cli."
            "clip_vqgan, aphantasia_torch.cli.illustrip\n"
            "for w in ('clip_fft.b32.720p', 'illustrip.b32.rgb.720p'):\n"
            "    c = core.Cell(w); c.driver()\n"
            "    [c.reader(m['name']) for m in c.per_layer()]\n"
            "print(core.forbidden_modules())\n") % core.REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=core.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_result_line_shape():
    compared = {"loss0_gap": {"value": 1e-4, "limit": 1e-3, "ok": True},
                "frame_gap": {"value": 3, "limit": 1, "ok": False}}
    line = core.result_line(
        False, 480, 0, {"steps_per_s": {"value": 24.1, "unit": "steps/s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 4 * 2 ** 30},
        compared, {"device_ops": [["k", 0.1]], "idle_gaps": [["draw", 0.01]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "compared"]
    assert out["correct"] is False and out["attempted"] == 480
    assert out["metrics"]["steps_per_s"] == {"value": 24.1,
                                             "unit": "steps/s"}
    assert out["compared"]["frame_gap"]["limit"] == 1
    lines = core.compared_lines(compared)
    assert lines == ["loss0_gap: 0.0001 limit 0.001",
                     "frame_gap: 3 limit 1  OVER"]
    no_trace = json.loads(core.result_line(True, 1, 0, {}, {}, {}))
    assert "breakdown" not in no_trace and list(no_trace)[-1] == "compared"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(core.BENCH_DIR, "run.py"),
         "--workload", "clip_fft.b32.720p", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=core.REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
