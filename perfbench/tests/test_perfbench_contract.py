"""BENCHMARK.json and the files it names, against the benchmark's rules;
and what the benchmark imports."""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from harness import data

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = data.benchmark()
FORBIDDEN = {"jax", "jaxlib", "flax", "tracking_sdf_tpu"}
SOURCES = sorted(data.PERFBENCH.rglob("*.py"))


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_cells_and_metrics():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and (data.ROOT / c["file"]).is_file()
        assert c["reduced"] == data.load_json(data.ROOT / c["file"])["reduced"] == []
        names.add(c["name"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (data.PERFBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (data.PERFBENCH / "limits" / f"{w['name']}.json").is_file()
        used.add(w["config"])
    assert used == names
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"]) and set(m["workloads"]) <= set(cells)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells) and m.get("workloads", cells)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_reports_setup_another_end_to_end_metric_and_what_its_layers_move(workload):
    e2e, per_layer = data.cell_metrics(BENCH, workload)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_a_configuration_file_is_the_port_preset_it_names(name):
    from tracking_sdf_tpu_torch.config import preset

    cfg = data.load_json(data.ROOT / f"perfbench/configs/{name}.json")
    built = data.pipeline_config(cfg, "t.txt")
    assert built == dataclasses.replace(preset(cfg["port_preset"]), trajectory_path="t.txt")


def test_file_names_are_made_of_name_characters():
    for p in data.PERFBENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(data.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=[p.relative_to(data.PERFBENCH).as_posix()
                                               for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_generator_and_the_reference_import_nothing_of_the_port():
    for path in [data.PERFBENCH / "harness" / "traffic.py", data.PERFBENCH / "harness" / "check.py",
                 *sorted((data.PERFBENCH / "reference").glob("*.py"))]:
        assert all(m.split(".")[0] != "tracking_sdf_tpu_torch" for m in _imports(path)), path
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import harness.traffic, harness.check, "
            "reference.step; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(data.PERFBENCH)], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & (FORBIDDEN | {"tracking_sdf_tpu_torch"})
