"""``correct`` on the CPU at a small size: a sound run passes the cell's
limits; the control (the reference stored in float8 in the program's
place) and each fault that a one-card cell can have, planted in the
program underneath a run, fail them; the result is one JSON line with the
numbers and limits last. The exchange between chips is a fault no cell
here can have: every cell takes one card."""
from __future__ import annotations

import json

import pytest
import torch

from harness import cell, check
from tracking_sdf_tpu_torch.fusion import brickmajor
from tracking_sdf_tpu_torch.pipeline import runner, trajectory


def _run(small, **kw):
    cfg, tr, limits = small
    return cell.run(cfg, tr, limits, 2 ** 31 + 77, 1.5, False, {}, device="cpu", **kw)


def test_a_sound_run_is_correct_and_its_last_line_parses(small):
    res = _run(small)
    line = json.loads(json.dumps(res))
    assert line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "limits"
    assert set(line["metrics"]) == {"frames_per_s", "chunk_ms_p95", "setup_s"}
    assert line["attempted"] >= 8 and line["failed"] == 0
    for k, v in line["limits"].items():
        assert v["value"] <= v["limit"], k


def test_every_session_repeats_the_first(small, monkeypatch, capsys):
    """The window restarts from the bootstrap state each session_frames
    frames, so every session does the same work: the same GN iterations
    and residuals at each frame of a session, and correct still holds for
    a sample drawn in a later session."""
    seen = {}
    add = cell.Window.add

    def record(self, t0, t1, stats):
        for s in stats:
            seen.setdefault(s.index, set()).add((s.gn_iterations, s.mean_abs_residual,
                                                 s.num_valid, s.rejected))
        add(self, t0, t1, stats)
    monkeypatch.setattr(cell.Window, "add", record)
    cfg, tr, limits = small
    res = cell.run(cfg, tr, limits, 2 ** 31 + 78, 3.0, False, {}, device="cpu")
    sessions = int(capsys.readouterr().err.split(" sessions over")[0].rsplit(" ", 1)[1])
    assert sessions >= 3 and res["correct"] is True
    assert sorted(seen) == list(range(2, 2 + tr["session_frames"]))
    assert all(len(v) == 1 for v in seen.values())


def test_the_control_fails_the_limits(small):
    res = _run(small, controls=("float8_e4m3fn",))
    limits = small[2]
    ctl = res["controls"]["float8_e4m3fn"]
    assert not check.judge(ctl, limits)
    assert res["correct"] is True


def _stamps(self, n, timestamps):
    return timestamps if timestamps is not None else [float(self.frame_num + 1 + i)
                                                      for i in range(n)]


def _unchanged(orig):
    """process_chunk that returns the state unchanged: no frame is tracked
    or fused; the records and trajectory lines carry the pose as it was."""
    def chunk(self, depths, rgbs=None, timestamps=None):
        out = []
        for ts in _stamps(self, len(depths), timestamps):
            self.frame_num += 1
            self._writer.write(ts, self.pose)
            out.append(runner.FrameStats(self.frame_num, ts, 0.0, 0.0, 0, 1000, 0.0))
        self.chunk_fuse_stats = [None] * len(depths)
        return out
    return chunk


def _half(orig):
    """process_chunk that processes the first half of the chunk; the other
    half's records and lines repeat its last pose."""
    def chunk(self, depths, rgbs=None, timestamps=None):
        h = len(depths) // 2
        ts = _stamps(self, len(depths), timestamps)
        out = orig(self, depths[:h], None if rgbs is None else rgbs[:h], timestamps=ts[:h])
        for t in ts[h:]:
            self.frame_num += 1
            self._writer.write(t, self.pose)
            out.append(runner.FrameStats(self.frame_num, t, 0.0, 0.0, 0, 1000, 0.0))
        self.chunk_fuse_stats = self.chunk_fuse_stats + [None] * (len(depths) - h)
        return out
    return chunk


@pytest.mark.parametrize("fault", ["unchanged", "half", "pose", "pose_one_in_eight", "rows"])
def test_a_fault_underneath_makes_correct_false(small, monkeypatch, fault):
    orig = runner.Reconstruction.process_chunk
    if fault == "unchanged":
        monkeypatch.setattr(runner.Reconstruction, "process_chunk", _unchanged(orig))
    elif fault == "half":
        monkeypatch.setattr(runner.Reconstruction, "process_chunk", _half(orig))
    elif fault.startswith("pose"):  # poses altered by 1 mm where they are written
        write = trajectory.TrajectoryWriter.write
        write_chunk = trajectory.TrajectoryWriter.write_chunk
        every = 8 if fault == "pose_one_in_eight" else 1

        def moved(self, ts, pose):
            shift = 1e-3 if int(ts) % every == 0 else 0.0
            write(self, ts, type(pose)(pose.R, pose.t + shift))

        def moved_chunk(self, timestamps, R, t, keep):
            # the chunk path writes its kept rows at once: the same shift on each
            shift = torch.tensor([1e-3 if int(ts) % every == 0 else 0.0 for ts in timestamps],
                                 dtype=t.dtype, device=t.device)
            return write_chunk(self, timestamps, R, t + shift[:, None], keep)
        monkeypatch.setattr(trajectory.TrajectoryWriter, "write", moved)
        monkeypatch.setattr(trajectory.TrajectoryWriter, "write_chunk", moved_chunk)
    else:  # each fused D value altered by 1 mm where K2 writes it
        fuse = brickmajor.brick_fuse_rows

        def moved_rows(D, *a, **k):
            fuse(D, *a, **k)
            D.add_(torch.where(torch.isfinite(D), 1e-3, 0.0).to(D.dtype))
        monkeypatch.setattr(brickmajor, "brick_fuse_rows", moved_rows)
    res = _run(small)
    assert res["correct"] is False
