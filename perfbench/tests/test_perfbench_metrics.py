"""The metric arithmetic on hand-made inputs: the window's rate and tail,
the trace's union of device intervals and its layers, the kernels' bytes,
and the data-driven layout (layer patterns and metric readers found by name)."""
from __future__ import annotations

import math
import re

import numpy as np
import pytest

from harness import bounds, cell, data, trace as tr


def _window(walls, gap=0.0, frames=8):
    w = cell.Window()
    t = 100.0
    for d in walls:
        w.add(t, t + d, [type("S", (), dict(rejected=False, gn_iterations=1))()] * frames)
        t += d + gap
    return w


def test_rate_is_over_the_whole_window_and_p95_over_every_chunk():
    walls = [0.01] * 95 + [0.05] * 5
    w = _window(walls, gap=0.001)
    m = cell.end_to_end(w, 3.5)
    span = sum(walls) + 0.001 * 99
    assert m["frames_per_s"]["value"] == pytest.approx(800 / span)
    assert m["chunk_ms_p95"]["value"] == pytest.approx(np.percentile(np.array(walls) * 1e3, 95))
    assert 10.0 < m["chunk_ms_p95"]["value"] < 50.0  # the tail's edge, not its mean
    assert m["setup_s"]["value"] == 3.5
    assert w.frames == 800 and len(w.walls) == 100


def test_rejected_frames_are_left_out_of_the_rate():
    w = _window([0.01] * 10)
    w.add(w.t_last, w.t_last + 0.01,
          [type("S", (), dict(rejected=True, gn_iterations=1))()] * 8)
    m = cell.end_to_end(w, 1.0)
    assert w.frames == 88 and w.rejected == 8
    assert m["frames_per_s"]["value"] == pytest.approx(80 / w.seconds)


def test_the_per_layer_rate_is_the_end_to_end_rate_of_its_window():
    w = _window([0.01] * 10, gap=0.002)
    w.add(w.t_last, w.t_last + 0.01,
          [type("S", (), dict(rejected=True, gn_iterations=1))()] * 8)
    read = data.metric_readers(["window_frames_per_s"])["window_frames_per_s"]
    assert read(dict(window=w)) == cell.end_to_end(w, 1.0)["frames_per_s"]["value"]
    assert read(dict(window=cell.Window())) is None


@pytest.mark.parametrize("workload, e2e", [
    ("tum256.handheld", ["chunk_ms_p95", "setup_s"]),
    ("tum256.slow", ["chunk_ms_p95", "setup_s"]),
    ("tum512.handheld", ["frames_per_s", "chunk_ms_p95", "setup_s"]),
])
def test_a_cell_reports_the_metrics_listed_for_it(workload, e2e):
    """frames_per_s is end to end in the cell that lists it alone; the
    host-paced cells carry it per layer as window_frames_per_s."""
    got, per_layer = data.cell_metrics(data.benchmark(), workload)
    assert got == e2e
    names = {m["name"] for m in per_layer}
    assert ("window_frames_per_s" in names) == ("frames_per_s" not in e2e)
    assert {"host_ms_per_chunk", "device_idle_pct", "gn_step_roofline"} <= names


def _ev(name, dev, a, b, parents=()):
    return dict(name=name, dev=dev, start=float(a), end=float(b), parents=list(parents))


def _group():
    span = lambda a, b: _ev(tr.CHUNK_SPAN, "cpu", a, b)  # noqa: E731
    return [
        span(0, 100), span(120, 200),
        _ev("cudaGraphLaunch", "cpu", 10, 20, [tr.CHUNK_SPAN]),
        _ev("cudaMemcpyAsync", "cpu", 60, 90, ["aten::copy_", "aten::_to_copy", "aten::to",
                                                tr.CHUNK_SPAN]),
        _ev("cudaMemcpyAsync", "cpu", 30, 31, ["aten::copy_", tr.CHUNK_SPAN]),  # not blocking
        _ev("cudaGraphLaunch", "cpu", 130, 140, [tr.CHUNK_SPAN]),
        _ev("cudaStreamSynchronize", "cpu", 150, 170, [tr.CHUNK_SPAN]),
        # overlapping kernels count once in the busy time
        _ev("void gn_step_kernel<bf16>", "cuda", 20, 50),
        _ev("void brick_fuse_rows_kernel", "cuda", 40, 60),
        _ev("void at::native::elementwise_kernel", "cuda", 140, 160),
        _ev(tr.CHUNK_SPAN, "cuda", 0, 100),  # the span's own annotation is no device op
    ]


def test_idle_share_is_the_union_of_device_intervals():
    pats = {"fusion": [re.compile("brick_fuse_rows_kernel")],
            "tracking": [re.compile("gn_step_kernel")]}
    red = tr.reduce([_group()], pats)
    assert red["window_s"] == pytest.approx(200e-6)
    assert red["busy_s"] == pytest.approx(60e-6)  # [20, 60] and [140, 160]
    assert red["layer_s"]["tracking"] == pytest.approx(30e-6)
    assert red["layer_s"]["fusion"] == pytest.approx(20e-6)
    assert red["layer_s"]["other"] == pytest.approx(20e-6)
    assert red["chunk_s"] == pytest.approx([100e-6, 80e-6])
    assert red["blocked_s"] == pytest.approx([30e-6, 20e-6])
    idle = red["idle_s"]
    assert sum(idle.values()) == pytest.approx(140e-6)
    assert idle[tr.HARNESS] == pytest.approx(20e-6)  # between the chunks
    assert idle["reading records"] == pytest.approx(40e-6)  # [60, 90] and [160, 170]
    assert idle["post-processing stats"] == pytest.approx(40e-6)
    assert idle["chunk set-up"] == pytest.approx(20e-6)  # [0, 10] and [120, 130]
    ctx = dict(trace=red)
    idle_pct = data.metric_readers(["device_idle_pct"])["device_idle_pct"](ctx)
    assert idle_pct == pytest.approx(70.0)
    host = data.metric_readers(["host_ms_per_chunk"])["host_ms_per_chunk"](ctx)
    assert host == pytest.approx(1e3 * (70e-6 + 60e-6) / 2)
    b = tr.breakdown(red)
    assert b["device_ops"][0] == ["void gn_step_kernel<bf16>", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) <= 10


CFG256 = data.load_json(data.PERFBENCH / "configs" / "tum256.json")
CFG512 = data.load_json(data.PERFBENCH / "configs" / "tum512.json")
PK = bounds.PEAKS["NVIDIA H100 80GB HBM3"]


def test_k1_bytes_on_hand_made_records():
    # tum256: levels (2, 1) at stride 3: 107 x 80 and 214 x 160 queries
    assert bounds.level_queries((480, 640), 6) == 80 * 107
    assert bounds.level_queries((480, 640), 3) == 160 * 214
    s = bounds.k1_frame_s(CFG256, (480, 640), 2, 30000, PK)
    v_coarse = 30000 * 8560 / 34240
    want = (2 * (34240 * 12 + 30000 * 16 + 192) + (8560 * 12 + v_coarse * 16 + 192)) / 3.35e12
    assert s == pytest.approx(want)
    # tum512 counts one step at each of its two coarse levels
    v12, v6 = 30000 * 2160 / 34240, 30000 * 8560 / 34240
    want512 = ((34240 * 12 + 30000 * 16 + 192) + (8560 * 12 + v6 * 16 + 192)
               + (2160 * 12 + v12 * 16 + 192)) / 3.35e12
    assert bounds.k1_frame_s(CFG512, (480, 640), 1, 30000, PK) == pytest.approx(want512)
    assert bounds.k1_frame_s(CFG256, (480, 640), 0, 30000, PK) < s


def test_k2_bytes_on_hand_made_records():
    # FULL 1000 (capped at 6144), FREE 3000 (capped at 2048), color on
    s = bounds.k2_frame_s(CFG256, (480, 640), [1000, 3000, 952, 0, 0], True, PK)
    row, crow = 512 * 2 * 4, (3 * 512 * 2 + 512 * 2) * 2
    pixels = 1000 * 512 // 16
    want = (1000 * (row + crow) + 2048 * row + pixels * 8 * 4 + (6144 + 2048) * 4 + 48) / 3.35e12
    assert s == pytest.approx(want)
    geo = bounds.k2_frame_s(CFG256, (480, 640), [1000, 3000, 952, 0, 0], False, PK)
    assert geo < s
    # the pixel rows read never pass the image
    big = bounds.k2_frame_s(CFG512, (480, 640), [28672, 0, 0, 0, 0], True, PK)
    assert big * 3.35e12 < 28672 * (row + crow) + 480 * 640 * 32 + 40000 * 4 + 49


def test_a_layer_file_or_a_metric_file_added_is_picked_up(tmp_path):
    base = tmp_path / "layers"
    (base / "fusion").mkdir(parents=True)
    (base / "fusion" / "k2.txt").write_text("# K2\nbrick_fuse_rows_kernel\n")
    assert data.layer_of("void brick_fuse_rows_kernel<1>", data.layer_patterns(base)) == "fusion"
    assert data.layer_of("void new_kernel<1>", data.layer_patterns(base)) == "other"
    (base / "fusion" / "k9.txt").write_text("new_kernel\n")
    (base / "render").mkdir()
    (base / "render" / "k8.txt").write_text("raycast_kernel\n")
    pats = data.layer_patterns(base)
    assert data.layer_of("void new_kernel<1>", pats) == "fusion"
    assert data.layer_of("raycast_kernel", pats) == "render"
    mdir = tmp_path / "metrics"
    mdir.mkdir()
    (mdir / "answer.py").write_text("def read(ctx):\n    return ctx['x'] * 2\n")
    assert data.metric_readers(["answer"], mdir)["answer"](dict(x=21)) == 42


def test_every_per_layer_metric_has_a_reader_and_every_cell_its_files():
    bench = data.benchmark()
    readers = data.metric_readers([m["name"] for m in bench["per_layer"]])
    assert set(readers) == {m["name"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        _, cfg, traffic, limits = data.cell(bench, w["name"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert set(limits) and all(math.isfinite(v) for v in limits.values())
