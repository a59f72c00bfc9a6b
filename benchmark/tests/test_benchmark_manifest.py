"""BENCHMARK.json against the benchmark's contract, and the lookup by
name that lets a later change add a cell with new files and entries."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark.harness import core

REPO = core.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return core.load_json(os.path.join(REPO, "BENCHMARK.json"))


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_full_check_fits_with_24_cells(manifest):
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for text in [c["source"] for c in manifest["configs"]] + [
            x["why"] for x in manifest["configs"] + manifest["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(names) == len(set(names))
    assert {m["name"] for m in manifest["end_to_end"]} >= {"setup_s"}


def test_every_cell_reports_what_its_metrics_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for w in cells:
        reported = {k for k, v in e2e.items() if w in v}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in manifest["per_layer"])
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}


def test_each_cell_finds_its_files(manifest):
    for w in manifest["workloads"]:
        cell = core.Cell(w["name"], manifest)
        assert os.path.isfile(cell.driver_path)
        assert cell.traffic["name"] == w["traffic"]
        assert cell.limits, f"no limits for {w['name']}"
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]).read)
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == []


def test_a_metric_variant_shares_its_base_reader():
    """`<base>.<part>` with no file of its own reads metrics/<base>.py; a
    file of the variant's own name comes first."""
    cell = core.Cell("clip_fft.b32.720p")
    for name in ("cut_roofline.still", "cut_roofline.video"):
        assert os.path.basename(cell.reader(name).__file__) == (
            "cut_roofline.py")
    assert os.path.basename(cell.reader("group_device_ms.still").__file__) == (
        "group_device_ms.py")


def test_adding_a_cell_needs_only_new_files_and_entries(manifest, tmp_path):
    """A new traffic mix, cell, per-layer metric and limits file, put
    beside a copy of the benchmark, are found by name with no code
    changed."""
    bench = tmp_path / "benchmark"
    shutil.copytree(core.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tr = core.load_json(str(bench / "traffic" / "clip_fft.720p.json"))
    tr.update(name="clip_fft.540p", flags=["--size", "960-540"])
    (bench / "traffic" / "clip_fft.540p.json").write_text(json.dumps(tr))
    (bench / "limits" / "clip_fft.b32.540p.json").write_text(
        json.dumps({"loss0_gap": 1.0}))
    (bench / "metrics" / "new_metric.still.py").write_text(
        "def read(lay):\n    return 1.0\n")
    m = json.loads(json.dumps(manifest))
    m["workloads"].append({"name": "clip_fft.b32.540p", "config": "clip-vitb32",
                           "traffic": "clip_fft.540p", "chips": 1,
                           "why": "a new cell"})
    m["per_layer"].append({"name": "new_metric.still", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "step loop", "moves": "steps_per_s",
                           "workloads": ["clip_fft.b32.540p"]})
    for e in m["end_to_end"]:
        if e["name"] == "steps_per_s":
            e["workloads"].append("clip_fft.b32.540p")
    cell = core.Cell("clip_fft.b32.540p", m, bench_dir=str(bench))
    assert cell.traffic["flags"] == ["--size", "960-540"]
    assert cell.limits == {"loss0_gap": 1.0}
    assert cell.driver().setup is not None
    names = [x["name"] for x in cell.per_layer()]
    assert names == ["new_metric.still"]
    assert cell.reader("new_metric.still").read({}) == 1.0
    assert [x["name"] for x in cell.end_to_end()] == [
        "steps_per_s", "peak_mem_mib", "setup_s"]


def test_traffic_settings_match_the_cli(manifest):
    """The reference's settings are what the CLI resolves from the
    traffic's flags (sizes, cutouts after the budget, padding, rate,
    colour and decay)."""
    import importlib
    for w in manifest["workloads"]:
        cell = core.Cell(w["name"], manifest)
        tr, s = cell.traffic, cell.traffic["settings"]
        cli = importlib.import_module("aphantasia_torch.cli." + tr["cli"])
        flags = list(tr["flags"]) + ["-t", "x", "--device", "cpu"]
        a = cli.get_args(flags)
        assert list(a.size) == s["size"]
        assert a.lrate == s["lr"]
        for key in ("decay", "colors", "contrast"):
            if key in s and hasattr(a, key):
                assert getattr(a, key) == s[key], key
        from aphantasia_torch.cli.common import apply_sample_budget
        assert apply_sample_budget(a.samples, a.model, None, 0, 0,
                                   a.transform) == s["cutouts"]
        assert a.transform == "fast" and a.sim == s["sim"]
        over = "over" in a.align
        h, w_ = s["size"]
        assert s["padded"] == ([int(1.5 * h), int(1.5 * w_)] if over
                               else [h, w_])
