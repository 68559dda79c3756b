"""Tracing inside the port: utils.profiling's switch and spans, the chunk
step's traced variant behind Reconstruction.chunk_trace, and the CLI's
--profile, which turns them on, on the CPU at test_torch_chunk.py's and
test_torch_cli.py's sizes (the step runs eagerly; the host clock fills the
stamps). The last test replays the traced graphs on the card and skips
without one."""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_chunk import (CAM, PRESETS, assert_bitwise, chunk_config, frame_tuple,
                              initial_pose, make_frames, new_recon)
from test_torch_cli import Run, camera_arg, sequence  # noqa: F401 (a fixture)
from tracking_sdf_tpu_torch import cli
from tracking_sdf_tpu_torch.pipeline import chunk as chunked
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
from tracking_sdf_tpu_torch.tracking import gn_reduce as k1
from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid
from tracking_sdf_tpu_torch.utils import profiling

torch.set_num_threads(2)

CHUNK_SPANS = {"tsdf.process_chunk", "tsdf.chunk.setup", "tsdf.chunk.issue", "tsdf.chunk.read",
               "tsdf.chunk.post", "tsdf.chunk.calibrate", "tsdf.trajectory.write",
               "tsdf.publish"}


@pytest.fixture
def tracing():
    """Tracing on, and off again after."""
    profiling.enable_tracing(True)
    try:
        yield
    finally:
        profiling.enable_tracing(False)


def test_a_span_off_never_calls_into_the_profiler(monkeypatch):
    def boom(*args):
        raise AssertionError("called into the profiler")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert not profiling.tracing_enabled()
    with profiling.span("tsdf.process_chunk", 3) as sp:
        with profiling.span("tsdf.chunk.post") as inner:
            assert sp is None and inner is None
    with pytest.raises(ValueError):
        profiling.device_stamp(torch.zeros(2, dtype=torch.int64))
    stamp = torch.zeros(1, dtype=torch.int64)
    t0 = time.perf_counter_ns()
    profiling.device_stamp(stamp)
    assert t0 <= int(stamp) <= time.perf_counter_ns()


def test_a_profiler_alone_traces_nothing(tmp_path, monkeypatch):
    """With the switch off, a process_chunk under torch.profiler marks no
    span and runs the untraced step: its records are REC wide and
    chunk_trace is None."""
    widths = []
    replay = chunked.ChunkSteps.replay

    def keep(self, *args):
        out = replay(self, *args)
        widths.append(out.shape[1])
        return out
    monkeypatch.setattr(chunked.ChunkSteps, "replay", keep)
    cfg = chunk_config("tum256", 48, str(tmp_path / "t.txt"))
    depths, rgbs = make_frames(5)
    r = new_recon(cfg)
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    r.close()
    assert not any(e.name.startswith("tsdf.") for e in prof.events())
    assert widths == [chunked.REC] and r.chunk_trace is None


def test_a_profiled_chunk_yields_its_spans_under_process_chunk(tracing, tmp_path):
    """Traced and under torch.profiler, a process_chunk with a rejected
    frame marks each span once per use, in order, nested under
    tsdf.process_chunk, whose input is the chunk's first frame index, as
    function-scope ranges (a user annotation would put a range on the
    device's timeline too). The trajectory is one batched write a chunk,
    whose input is the number of lines it wrote."""
    cfg = chunk_config("tum256", 48, str(tmp_path / "t.txt"))
    depths, rgbs = make_frames(5, nan_frame=3)
    r = new_recon(cfg, chunk_metrics=True)
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        stats = r.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    r.close()
    events = [e for e in prof.events() if e.name.startswith("tsdf.")]
    names = [e.name for e in events]
    assert set(names) == CHUNK_SPANS
    writes = sum(not s.rejected for s in stats)
    assert all(names.count(k) == 1 for k in CHUNK_SPANS)
    top = next(e for e in events if e.name == "tsdf.process_chunk")
    assert list(top.concrete_inputs) == [2]
    write = next(e for e in events if e.name == "tsdf.trajectory.write")
    assert list(write.concrete_inputs) == [writes] == [3]
    assert len((tmp_path / "t.txt").read_text().splitlines()) == 1 + writes
    for e in events:
        assert e.scope != int(torch._C._profiler.RecordScope.USER_SCOPE), e.name
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        if e.name != "tsdf.process_chunk":
            assert "tsdf.process_chunk" in chain, e.name
        if e.name in ("tsdf.chunk.calibrate", "tsdf.trajectory.write", "tsdf.publish"):
            assert chain[0] == "tsdf.chunk.post", e.name
    phases = sorted((e for e in events if e.name in ("tsdf.chunk.setup", "tsdf.chunk.issue",
                                                      "tsdf.chunk.read", "tsdf.chunk.post")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in phases] == ["tsdf.chunk.setup", "tsdf.chunk.issue",
                                        "tsdf.chunk.read", "tsdf.chunk.post"]
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(phases, phases[1:]))
    assert (top.time_range.start <= phases[0].time_range.start
            and phases[-1].time_range.end <= top.time_range.end)


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_tracing_leaves_records_poses_rows_and_trajectory_bitwise(tmp_path, monkeypatch,
                                                                  name, m, fusion):
    """Two chunks, frame 3 all NaN (rejected): one Reconstruction traces the
    first chunk and not the second, the other traces neither. The records'
    own slots, the FrameStats, FuseStats, poses, velocity carry, rows and
    trajectory files are bit for bit the same, and chunk_trace is there
    only for the traced chunk."""
    records = []
    replay = chunked.ChunkSteps.replay

    def keep(self, *args):
        out = replay(self, *args)
        records.append(out)
        return out
    monkeypatch.setattr(chunked.ChunkSteps, "replay", keep)
    depths, rgbs = make_frames(9, nan_frame=3)
    runs = []
    for traced in (True, False):
        cfg = chunk_config(name, m, str(tmp_path / f"{traced}.txt"), **fusion)
        r = new_recon(cfg)
        r.process_frame(depths[0], rgbs[0], timestamp=0.0)
        profiling.enable_tracing(traced)
        try:
            stats = r.process_chunk(np.stack(depths[1:5]), np.stack(rgbs[1:5]))
        finally:
            profiling.enable_tracing(False)
        trace, fuse = r.chunk_trace, list(r.chunk_fuse_stats)
        stats += r.process_chunk(np.stack(depths[5:]), np.stack(rgbs[5:]))
        assert r.chunk_trace is None
        r.close()
        runs.append((r, stats, trace, fuse + r.chunk_fuse_stats))
    (a, sa, ta, fa), (b, sb, tb, fb) = runs
    levels = len(a.config.pyramid_levels)
    assert tb is None and ta.stamps.shape == (4, 2) and ta.full_steps.shape == (4, levels)
    assert records[0].shape == (4, chunked.traced_layout(levels)[1])
    assert [r.shape for r in records[1:]] == [(4, chunked.REC)] * 3
    for x, y in ((records[0], records[2]), (records[1], records[3])):
        assert torch.equal(x[:, :chunked.REC].view(torch.int32), y.view(torch.int32))
    assert [frame_tuple(s) for s in sa] == [frame_tuple(s) for s in sb]
    assert sa[2].rejected and sum(s.rejected for s in sa) == 1
    assert fa == fb
    assert_bitwise(a, b)
    assert (tmp_path / "True.txt").read_bytes() == (tmp_path / "False.txt").read_bytes()


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_chunk_trace_counts_are_each_levels_own(tracing, name, m, fusion):
    """A traced chunk of four frames: its finest level's full steps are the
    FrameStats' GN iterations, and each level's full steps are those of
    track_frame_pyramid run directly from the same
    pose guess against the same rows (one-frame traced chunks, the same
    step, hold the rows and carry of each frame's start)."""
    cfg = chunk_config(name, m, **fusion)
    depths, rgbs = make_frames(5)
    a, b = new_recon(cfg), new_recon(cfg)
    for r in (a, b):
        r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    stats = a.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    tr = a.chunk_trace
    assert tr.full_steps[:, -1].tolist() == [s.gn_iterations for s in stats]
    assert (tr.stamps[:, 1] >= tr.stamps[:, 0]).all()
    assert (tr.stamps[1:, 0] >= tr.stamps[:-1, 1]).all()
    for k in range(4):
        pts, _ = preprocess_frame(torch.from_numpy(depths[1 + k]), cam=CAM,
                                  bilateral=cfg.bilateral_filter,
                                  bilateral_mode=cfg.bilateral_mode)
        _, levels = track_frame_pyramid(None, b._predict_pose(), pts, params=cfg.grid,
                                        cfg=cfg.tracking, levels=cfg.pyramid_levels,
                                        Dm=b._dm)
        direct = [lv.read() for lv in levels]
        b.process_chunk(depths[1 + k][None], rgbs[1 + k][None])
        assert b.chunk_trace.full_steps[0].tolist() == [s.iterations for s in direct]
        assert torch.equal(b.chunk_trace.full_steps[0], tr.full_steps[k])
    assert any(n > 1 for n in tr.full_steps[:, 0].tolist())  # a coarse level iterated
    a.close()
    b.close()


def test_cli_profile_traces_the_chunks_into_the_metrics_log(sequence, tmp_path,  # noqa: F811
                                                            monkeypatch):
    """``--profile DIR --chunk 4`` over 7 frames: tracing is on for the run
    and off after it; the Chrome trace holds the one chunk's span, and the
    chunked frames' metrics-log lines (indices 2-5) carry their step's two
    device stamps and each level's full GN steps, the finest equal to the
    frame's GN iterations; the per-frame lines (the bootstrap frame and the
    odd tail) carry neither."""
    root, stats = sequence
    log = str(tmp_path / "m.jsonl")
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--chunk", "4",
                    "--frames", "7", "--profile", str(tmp_path / "prof"), "--metrics-log", log],
              tmp_path, "prof", monkeypatch)
    assert got.rc == 0 and not profiling.tracing_enabled()
    with open(log) as f:
        rows = [json.loads(x) for x in f]
    assert [r["index"] for r in rows] == list(range(1, 8))
    assert [r["index"] for r in rows if "device_ns" in r or "gn_steps" in r] == [2, 3, 4, 5]
    levels = got.recon._chunk_steps.levels
    for r in rows[1:5]:
        assert r["device_ns"][0] <= r["device_ns"][1]
        assert len(r["gn_steps"]) == levels and r["gn_steps"][-1] == r["gn_iterations"]
    with open(tmp_path / "prof" / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("tsdf.process_chunk") == 1 and "tsdf.chunk.post" in names


def test_central_span_marks_each_level_issue_when_on(tmp_path, monkeypatch):
    """tum256central: with the switch off a frame's central level calls
    nothing of the profiler; on, ``tsdf.track.central`` marks the issue of
    each tracked frame's level, per frame and in each eager chunk step,
    inside ``tsdf.chunk.issue``; the records' GN counts are its one level."""
    cfg = chunk_config("tum256central", 48, str(tmp_path / "t.txt"))
    depths, rgbs = make_frames(6)
    r = new_recon(cfg)

    def boom(*args):
        raise AssertionError("called into the profiler")
    with monkeypatch.context() as mp:
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
        r.process_frame(depths[0], rgbs[0], timestamp=0.0)
        r.process_frame(depths[1], rgbs[1], timestamp=1.0)
    profiling.enable_tracing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.process_frame(depths[2], rgbs[2], timestamp=2.0)
            stats = r.process_chunk(np.stack(depths[3:]), np.stack(rgbs[3:]))
    finally:
        profiling.enable_tracing(False)
    r.close()
    spans = [e for e in prof.events() if e.name == "tsdf.track.central"]
    assert len(spans) == 4
    parents = []
    for e in spans:
        p = e.cpu_parent
        parents.append(p.name if p is not None else None)
    assert parents.count("tsdf.chunk.issue") == 3
    assert r.chunk_trace.full_steps.shape == (3, 1)
    assert r.chunk_trace.full_steps[:, 0].tolist() == [s.gn_iterations for s in stats]


def test_the_counter_names_follow_launch_counts():
    """LAUNCH_COUNTERS names each of launch_counts()'s counters, in its
    order, as "<module>.<counter>", K1's central form's among them, so that
    a reader finds a counter by name; the benchmark's reader of
    central_full_step_pct reads its slot by that name."""
    import importlib.util
    import os

    from tracking_sdf_tpu_torch.tracking import gn_reduce

    names = chunked.LAUNCH_COUNTERS
    saved = chunked.launch_counts()
    assert len(names) == len(saved) == len(set(names))
    try:
        chunked._set_launch_counts(range(100, 100 + len(names)))
        for (mod, attr), name, v in zip(chunked._COUNTERS, names, chunked.launch_counts()):
            assert name == f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}" and getattr(mod, attr) == v
        k = names.index("gn_reduce.launches_step_central")
        assert chunked.launch_counts()[k] == gn_reduce.launches_step_central == 100 + k
    finally:
        chunked._set_launch_counts(saved)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perfbench", "metrics", "central_full_step_pct.py")
    spec = importlib.util.spec_from_file_location("central_full_step_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    launches = [0] * len(names)
    launches[k] = 400
    window = type("W", (), dict(iterations=[5, 6, 4, 5] * 5))()
    assert mod.read(dict(launches=launches, window=window)) == pytest.approx(25.0)
    launches[k] = 0
    assert mod.read(dict(launches=launches, window=window)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name,fusion,per_frame", [("tum256", {}, 36),
                                                   ("tum512", {"cap_mixed": 8}, 48),
                                                   ("tum256central", {}, 26)])
def test_traced_replays_on_the_card(name, fusion, per_frame):
    """On the card: replays of the untraced graphs add the presets' launches
    a frame to the counters (K1's 10 a coarse level and 20 at the finest,
    or tum256central's 20 of K1's central form at its one level, K3-K7 and
    K2), and so do the traced graphs (the stamp kernel is no counted
    launch). The traced chunk's stamps rise frame by frame, the span from
    the first to the last fits in the chunk's wall time, and the finest
    level's full steps are the FrameStats' GN iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg = chunk_config(name, 64, **fusion)
    depths, rgbs = make_frames(9)
    r = Reconstruction(CAM, cfg, device="cuda", initial_pose=initial_pose())
    r.chunk_phase_metrics = False
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)

    def chunk(k):
        before = sum(chunked.launch_counts())
        t0 = time.perf_counter()
        stats = r.process_chunk(np.stack(depths[1 + 4 * k:5 + 4 * k]),
                                np.stack(rgbs[1 + 4 * k:5 + 4 * k]))
        return stats, sum(chunked.launch_counts()) - before, time.perf_counter() - t0

    central = k1.launches_step_central
    _, launches, _ = chunk(0)
    assert launches == 4 * per_frame and r.chunk_trace is None
    assert k1.launches_step_central - central == (
        4 * cfg.tracking.max_iterations if cfg.tracking.jacobian == "central" else 0)
    profiling.enable_tracing(True)
    try:
        stats, launches, wall = chunk(1)
    finally:
        profiling.enable_tracing(False)
    r.close()
    assert launches == 4 * per_frame
    st = r.chunk_trace.stamps
    assert (st[:, 1] > st[:, 0]).all() and (st[1:, 0] >= st[:-1, 1]).all()
    assert 0 < int(st[-1, 1] - st[0, 0]) <= wall * 1e9
    assert r.chunk_trace.full_steps[:, -1].tolist() == [s.gn_iterations for s in stats]
