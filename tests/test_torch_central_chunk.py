"""The central-difference tracker on the chunked brick-major path (preset
``tum256central``: the 13 Shepard-L1 probes a pixel on the D and W rows in
place, one level at pixel_stride) on the CPU, where K1's central form takes
its plain version, ``gn_reduce.central_step_reference``.

Chunked against per frame bit for bit at test_torch_chunk.py's sizes; the
plain step against its parts; the rows' probes against the dense grid's;
no dense grid on the tracked path; and, at the benchmark's small cell
(perfbench/tests/conftest.py's sizes), a chain of the port's chunks against
the benchmark's plain central reference (perfbench/reference/
track_central.py) under the cell's limits, with the float8 control outside
them.
"""
import copy
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_chunk import (assert_bitwise, chunk_config, frame_tuple, make_frames,
                              new_recon, per_frame)
from tracking_sdf_tpu_torch.config import GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.data.tum import TUMFrame
from tracking_sdf_tpu_torch.fusion import brickmajor as bm
from tracking_sdf_tpu_torch.grid.grid import empty_grid
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, BrickRows, shepard_l1
from tracking_sdf_tpu_torch.pipeline import runner
from tracking_sdf_tpu_torch.tracking import gauss_newton as tgn
from tracking_sdf_tpu_torch.tracking import gn_reduce as g

torch.set_num_threads(2)

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "perfbench")
BS = (8, 8, 8)


@pytest.mark.parametrize("pose_init", ["previous", "velocity"])
def test_central_chunks_match_per_frame(tmp_path, pose_init):
    """Frames 1-9 in three chunks of three, frame 5 all NaN (rejected):
    rejection flags, GN iterations, valid counts, mean residuals,
    FuseStats, trajectories, poses, velocity carry and rows are the
    per-frame loop's bit for bit."""
    depths, rgbs = make_frames(10, nan_frame=5)
    cfgs = [dataclasses.replace(chunk_config("tum256central", 48, str(tmp_path / f"{w}.txt")),
                                pose_init=pose_init) for w in ("frame", "chunk")]
    assert cfgs[0].tracking.jacobian == "central" and cfgs[0].pyramid_levels is None
    seq, fuse_seq = per_frame(cfgs[0], depths, rgbs)
    chk = new_recon(cfgs[1])
    chk.process_frame(depths[0], rgbs[0], timestamp=0.0)
    stats, fuse = [], []
    for k in range(3):
        sl = slice(1 + 3 * k, 4 + 3 * k)
        stats += chk.process_chunk(np.stack(depths[sl]), np.stack(rgbs[sl]),
                                   timestamps=[float(i) for i in range(sl.start, sl.stop)])
        fuse += chk.chunk_fuse_stats
    chk.close()
    assert [frame_tuple(s) for s in stats] == [frame_tuple(s) for s in seq.stats[1:]]
    assert stats[4].rejected and sum(s.rejected for s in stats) == 1
    assert sum(s.gn_iterations for s in stats) > 9
    assert fuse == fuse_seq[1:]
    assert_bitwise(seq, chk)
    with open(tmp_path / "frame.txt") as a, open(tmp_path / "chunk.txt") as b:
        assert a.read() == b.read()


def _field(m: int, seed: int):
    """A seeded sphere field over an m^3 grid in bfloat16 brick-major rows
    (a fifth of the voxels unobserved) and its dense grid."""
    params = GridParams(m=m, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                        delta=0.15, epsilon=0.02)
    gen = torch.Generator().manual_seed(seed)
    grid = empty_grid(params, device="cpu")
    ijk = torch.stack(torch.meshgrid(*[torch.arange(m, dtype=torch.float32)] * 3,
                                     indexing="ij"), -1)
    world = (ijk + 0.5) * 2.0 / m - 1.0
    grid.D.copy_(((world - torch.tensor([0.05, -0.1, 0.1])).norm(dim=-1) - 0.6).clamp(-0.15, 0.15))
    grid.W.copy_(torch.where(torch.rand(m, m, m, generator=gen) < 0.2, 0.0,
                             torch.randint(1, 60, (m, m, m), generator=gen).float()))
    bg = bm.brick_grid_from_dense(grid, BS, value_dtype=torch.bfloat16,
                                  weight_dtype=torch.bfloat16)
    return params, bg, bm.dense_from_brick_grid(bg, params, BS)


def _queries(params: GridParams, seed: int):
    """A pose and camera points whose queries lie inside the grid, astride
    its faces, outside it and on voxel centres, with NaN holes."""
    gen = torch.Generator().manual_seed(seed)
    m = params.m
    uvw = torch.cat([torch.rand(1500, 3, generator=gen) * (m + 4.0) - 2.0,
                     torch.randint(0, m, (300, 3), generator=gen).float(),
                     torch.rand(200, 3, generator=gen) * 2.0 - 0.5,
                     m - 1.5 + torch.rand(200, 3, generator=gen) * 2.0])
    c, s = np.cos(0.2), np.sin(0.2)
    R = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    pose = Pose(R, torch.tensor([0.1, -0.05, 0.2]))
    x = (uvw.double() + 0.5) * 2.0 / m - 1.0
    pts = ((x - pose.t.double()) @ R.double()).float()
    pts[::53] = float("nan")
    return pose, pts


def test_shepard_on_the_rows_is_the_dense_grids():
    """The Shepard probe against the brick-major D and W rows in place
    (BrickRows: D is NaN where W <= 0, taken as 0 by a select) gives the
    dense grid's values and validity bit for bit, and the central
    residuals follow."""
    params, bg, dense = _field(32, 5)
    rows = bm.brick_rows_view(bg, params, BS)
    assert isinstance(rows, BrickRows) and isinstance(rows.W, BrickMaskedView)
    assert rows.D.rows.data_ptr() == bg.D.data_ptr() and rows.W.rows.data_ptr() == bg.W.data_ptr()
    coords = torch.rand(4000, 3, generator=torch.Generator().manual_seed(3)) * 36.0 - 2.0
    v_rows, ok_rows = shepard_l1(rows.D, rows.W, coords)
    v_dense, ok_dense = shepard_l1(dense.D, dense.W, coords)
    assert torch.equal(ok_rows, ok_dense) and 0 < int(ok_rows.sum()) < ok_rows.numel()
    assert torch.equal(v_rows.view(torch.int32), v_dense.view(torch.int32))
    pose, pts = _queries(params, 6)
    a = tgn.pixel_residuals_central(rows, pose, pts, params=params)
    b = tgn.pixel_residuals_central(dense, pose, pts, params=params)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("convergence", ["norm", "signed"])
def test_central_step_reference_is_residuals_sums_and_advance(convergence):
    """``central_step_reference`` (and ``central_stepper`` on CPU tensors)
    is ``pixel_residuals_central``'s terms added by
    ``sums_in_launch_order``, then ``advance_state``, step by step, bit for
    bit; a level frozen by its done flag or its step count stays so."""
    params, bg, _ = _field(32, 7)
    rows = bm.brick_rows_view(bg, params, BS)
    pose, pts = _queries(params, 8)
    cfg = TrackingConfig(jacobian="central", convergence=convergence, max_iterations=6)
    pose0 = Pose(pose.R, pose.t + torch.tensor([0.01, -0.008, 0.005]))
    a, b = g.init_state(pose0, cfg.damping), g.init_state(pose0, cfg.damping)
    step = g.central_stepper(rows, b, pts, params, cfg)
    for _ in range(cfg.max_iterations + 2):
        before = a.clone()
        phi, J, mask = tgn.pixel_residuals_central(rows, g.state_pose(a), pts, params=params,
                                                   v_h=cfg.v_h, w_h=cfg.w_h)
        assert int(mask.sum()) > 100
        g.advance_state(a, *g.unpack(g.sums_in_launch_order(g.terms_of(phi, J, mask))), cfg)
        step()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if not bool(g.level_active(before, cfg)):
            assert torch.equal(a.view(torch.int32), before.view(torch.int32))
    assert int(a.view(torch.int32)[g.S_COUNT]) >= 2
    res = tgn.track_frame(rows, pose0, pts, params=params, cfg=cfg)
    assert torch.equal(res.state.view(torch.int32), a.view(torch.int32))


def test_central_tracking_builds_no_dense_grid(tmp_path, monkeypatch):
    """With jacobian="central" on brick-major rows neither the per-frame
    loop, process_chunk nor run(chunk=N) builds the dense grid, and
    run(chunk=N) takes the chunked path without a warning."""
    def refuse(*a, **k):
        raise AssertionError("dense grid built on the tracked path")
    monkeypatch.setattr(runner, "dense_from_brick_grid", refuse)
    monkeypatch.setattr(bm, "dense_from_brick_grid", refuse)
    depths, rgbs = make_frames(9)
    r = new_recon(chunk_config("tum256central", 48, str(tmp_path / "t.txt")))
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    r.process_frame(depths[1], rgbs[1], timestamp=1.0)
    r.process_chunk(np.stack(depths[2:5]), np.stack(rgbs[2:5]))
    calls = []
    process_chunk = r.process_chunk
    r.process_chunk = lambda *a, **k: calls.append(len(a[0])) or process_chunk(*a, **k)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.run(iter([TUMFrame(float(i), depths[i], rgbs[i]) for i in range(5, 9)]), chunk=4)
    r.close()
    assert calls == [4] and r.frame_num == 9
    assert sum(s.gn_iterations for s in r.stats[1:]) > 8


# --- the benchmark's small cell, against its plain central reference ----------

def _card_arithmetic(monkeypatch):
    """The plain finish solving in float64 and updating in float32 as K1's
    finish does on the card, as the benchmark's plain reference does (the
    benchmark's CPU tests patch the port alike: on the CPU its finish
    solves in float32). The central step already adds in K1's launch
    order."""
    from reference import track as rt

    def card_finish(state, A, b, nvalid, sum_abs, cfg):
        ints = state.view(torch.int32)
        if not bool(g.level_active(state, cfg)):
            return
        pose = g.state_pose(state)
        lam = state[g.S_LAM].numpy()
        tw = rt.solve(A.numpy(), b.numpy(), float(lam)).astype(np.float32)
        if not np.isfinite(tw).all():
            tw = np.zeros(6, np.float32)
        count = int(ints[g.S_COUNT])
        done = bool((np.abs(tw) < np.float32(cfg.max_twist_diff)).all()
                    and count + 1 >= cfg.min_iterations)
        R, t = rt.update(pose.R.numpy(), pose.t.numpy(), tw)
        state[:g.S_COUNT] = torch.from_numpy(np.concatenate([
            R.reshape(9), t, [np.float32(lam * np.float32(cfg.damping_decay))], tw,
            [nvalid.numpy(), sum_abs.numpy()]]).astype(np.float32))
        ints[g.S_COUNT] = count + 1
        ints[g.S_DONE] = int(done)
    monkeypatch.setattr(g, "advance_state", card_finish)


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's packages on the path, and the port's finish in the
    card's arithmetic."""
    monkeypatch.syspath_prepend(PERFBENCH)
    _card_arithmetic(monkeypatch)


def _small_cell():
    """tum256central.handheld cut as the benchmark's CPU tests cut a cell:
    a 64^3 grid, 80x60 frames, 20 frames in chunks of 4, sessions of 12,
    and the cell's own limits."""
    from harness import data

    bench = data.benchmark()
    _, cfg, tr, limits = data.cell(bench, "tum256central.handheld")
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["grid"]["m"] = 64
    cfg["camera"] = dict(fx=517.3 / 8, fy=516.5 / 8, cx=318.6 / 8, cy=255.3 / 8, width=80,
                         height=60)
    tr["frames"], tr["chunk"], tr["session_frames"] = 20, 4, 12
    return cfg, tr, limits


def test_a_central_chain_is_correct_and_its_control_is_not(bench):
    """One run of the benchmark's cell harness on the CPU: the port's chunks
    against the plain central reference stay within the limits of
    tum256central.handheld (the same as tum256.handheld's), and the
    reference stored in float8 in the port's place falls outside them."""
    from harness import cell, check, data

    cfg, tr, limits = _small_cell()
    assert cfg["tracking"]["jacobian"] == "central" and cfg["pipeline"]["pyramid_levels"] is None
    assert limits == data.load_json(data.PERFBENCH / "limits" / "tum256.handheld.json")
    res = cell.run(cfg, tr, limits, 2 ** 31 + 2024, 1.5, False, {}, device="cpu",
                   controls=("float8_e4m3fn",))
    assert res["correct"] is True, res["limits"]
    assert res["attempted"] >= 8 and res["failed"] == 0
    assert not check.judge(res["controls"]["float8_e4m3fn"], limits)
