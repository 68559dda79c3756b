"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root, and under perfbench/ a configuration file (configs/<config>.json), a
traffic file (traffic/<traffic>.json) and a limits file
(limits/<cell>.json) for each cell, a directory of kernel-name patterns for
each layer (layers/<layer>/*.txt) and a reader for each per-layer metric
(metrics/<metric>.py). A later cell, metric or kernel adds files here and
entries in BENCHMARK.json; nothing in this module names one."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Tuple

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> Tuple[dict, dict, dict, dict]:
    """(workload entry, configuration file, traffic file, limits file) of a cell."""
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    return (wl, load_json(ROOT / entry["file"]),
            load_json(PERFBENCH / "traffic" / f"{wl['traffic']}.json"),
            load_json(PERFBENCH / "limits" / f"{name}.json"))


def cell_metrics(bench: dict, name: str) -> Tuple[List[str], List[dict]]:
    """(names of the end-to-end metrics, per-layer entries) that the cell
    ``name`` reports: a metric with a ``workloads`` key in the cells it
    lists, one without it in every cell."""
    every = [w["name"] for w in bench["workloads"]]
    e2e = [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", every)]
    return e2e, [m for m in bench["per_layer"] if name in m.get("workloads", every)]


def layer_patterns(base: Path = PERFBENCH / "layers") -> Dict[str, List[re.Pattern]]:
    """Each layer directory's kernel-name patterns: every non-empty line of
    every .txt file in it that is not a # comment, as a regular expression
    searched in the kernel's name."""
    out = {}
    for d in sorted(p for p in base.iterdir() if p.is_dir()):
        pats = []
        for f in sorted(d.glob("*.txt")):
            for line in f.read_text().splitlines():
                line = line.strip()
                if line and not line.startswith("#"):
                    pats.append(re.compile(line))
        out[d.name] = pats
    return out


def layer_of(name: str, patterns: Dict[str, List[re.Pattern]]) -> str:
    """The first layer (in name order) with a pattern found in ``name``, or
    "other"."""
    for layer, pats in patterns.items():
        if any(p.search(name) for p in pats):
            return layer
    return "other"


def metric_readers(names, base: Path = PERFBENCH / "metrics") -> Dict[str, Callable]:
    """The ``read(ctx)`` function of metrics/<name>.py for each name."""
    out = {}
    for name in names:
        path = base / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def pipeline_config(cfg: dict, trajectory_path: str):
    """The port's PipelineConfig of a configuration file, with the
    trajectory written to ``trajectory_path``."""
    from tracking_sdf_tpu_torch import config as pc

    f = dict(cfg["fusion"])
    f["brick_shape"] = tuple(f["brick_shape"])
    p = dict(cfg["pipeline"])
    p["pyramid_levels"] = tuple(p["pyramid_levels"]) if p["pyramid_levels"] else None
    g = dict(cfg["grid"])
    g["origin"] = tuple(g["origin"])
    return pc.PipelineConfig(grid=pc.GridParams(**g), tracking=pc.TrackingConfig(**cfg["tracking"]),
                             fusion=pc.FusionConfig(**f), trajectory_path=trajectory_path, **p)
