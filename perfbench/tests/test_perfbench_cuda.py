"""On the card: a short run of each cell through the benchmark's command,
correct and one JSON line last; and the command without the program
beside it exits non-zero with no result. On the CPU these tests skip."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from harness import data

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", [w["name"] for w in data.benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(workload, trace):
    _need_card()
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", str(trace)],
                         cwd=data.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = ({m["name"] for m in data.benchmark()["per_layer"]} if trace else
            {m["name"] for m in data.benchmark()["end_to_end"]})
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]


def test_without_the_program_the_command_exits_nonzero(tmp_path):
    _need_card()
    shutil.copy(data.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(data.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tum256.handheld",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and not out.stdout.strip()
