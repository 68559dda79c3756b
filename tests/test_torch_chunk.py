"""The port's chunked runner (process_chunk, run(chunk=N)) against its
per-frame loop and against the JAX package's process_chunk, on the CPU,
where the chunk's frame step runs eagerly (the card replays it as a CUDA
graph; chip_smoke.py holds the two against each other there).

Sizes of test_torch_slice.py: the presets shrunk to a 2 m cube at m=48
(tum256) or m=64 (tum512, cap_mixed 8), a 96x72 camera, over a sphere, a box
and a wall. brick_cap is 4·NB, so each of the per-frame loop's cap levels
holds all NB bricks (no FULL brick drops, whichever level it picks), and
brick_cap_free is NB. Tolerances: against the port's own per-frame loop,
bitwise (the same ops in the same order; the per-frame loop adapts its cap
and a chunk holds the largest, which changes only the padding of the brick
lists); against the JAX package's chunk, those of test_torch_slice.py: pose
1e-4, the bf16 grid's observed mask equal, W to rtol 2^-7, D to 2δ/128.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_slice import BOX, CAM, PARAMS, SPHERE, WALL, Scene, _orbit
from tracking_sdf_tpu.config import preset as jpreset
from tracking_sdf_tpu.data.synthetic import render_scene_depth
from tracking_sdf_tpu.pipeline import Reconstruction as JReconstruction
from tracking_sdf_tpu.pipeline import Trajectory as JTrajectory
from tracking_sdf_tpu.pipeline.trajectory import rpe_rmse as jrpe_rmse
from tracking_sdf_tpu_torch.config import preset
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.data.tum import TUMFrame
from tracking_sdf_tpu_torch.fusion.brickmajor import fuse_frame_brickmajor_core
from tracking_sdf_tpu_torch.pipeline.chunk import color_cadence, decode_tum_depth
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.pipeline.trajectory import Trajectory, rpe_rmse
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

torch.set_num_threads(2)

PRESETS = [("tum256", 48, {}), ("tum512", 64, {"cap_mixed": 8})]


def chunk_config(name, m, trajectory_path=None, package=preset, **fusion):
    cfg = package(name)
    nb = (m // 8) ** 3
    return dataclasses.replace(
        cfg, grid=PARAMS._replace(m=m), trajectory_path=trajectory_path,
        fusion=cfg.fusion._replace(brick_cap=4 * nb, brick_cap_free=nb, **fusion))


def make_frames(n, nan_frame=None):
    """n depth frames (float32 meters, a moving block of holes; ``nan_frame``
    all NaN) and n uniform colors."""
    rng = np.random.default_rng(1)
    depths, rgbs = [], []
    for i, p in enumerate(_orbit(n, dist=2.45)):
        depth = np.array(render_scene_depth(Scene((SPHERE, BOX, WALL)), CAM, p))
        depth[30:40, 10 + 4 * i:25 + 4 * i] = np.nan
        if i == nan_frame:
            depth[:] = np.nan
        depths.append(depth)
        rgbs.append(np.broadcast_to(rng.uniform(size=3), depth.shape + (3,)).astype(np.float32))
    return depths, rgbs


def initial_pose():
    p0 = _orbit(7, dist=2.45)[0]
    return pose_from_numpy(p0.R, p0.t, device="cpu")


def new_recon(cfg, chunk_metrics=False):
    r = Reconstruction(CAM, cfg, device="cpu", initial_pose=initial_pose())
    r.chunk_phase_metrics = chunk_metrics
    return r


def per_frame(cfg, depths, rgbs):
    """The per-frame loop; returns it and its FuseStats per frame (None on a
    rejected frame)."""
    r = new_recon(cfg)
    fuse = []
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        st = r.process_frame(d, c, timestamp=float(i))
        fuse.append(None if st.rejected else r.last_fuse_stats)
    r.close()
    return r, fuse


def assert_bitwise(a, b):
    """Equal poses, velocity carry and brick rows, bit for bit."""
    assert torch.equal(a.pose.R, b.pose.R) and torch.equal(a.pose.t, b.pose.t)
    assert (a._pose_prev is None) == (b._pose_prev is None)
    if a._pose_prev is not None:
        assert torch.equal(a._pose_prev.t, b._pose_prev.t)
    for k in ("D", "W", "C"):
        x, y = getattr(a.brick_grid, k), getattr(b.brick_grid, k)
        assert torch.equal(x.view(torch.int16), y.view(torch.int16)), k


def frame_tuple(s):
    return (s.rejected, s.gn_iterations, s.num_valid, s.mean_abs_residual)


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_chunk_matches_per_frame(tmp_path, name, m, fusion):
    """Frames 1-6 in one chunk, frame 4 all NaN, velocity prediction on: the
    gate fires on the NaN frame, and rejection flags, GN iterations, valid
    counts, mean residuals, FuseStats, trajectories, poses and rows equal
    the per-frame loop's. The phase calibration splits the chunk's time."""
    depths, rgbs = make_frames(7, nan_frame=4)
    cfgs = [dataclasses.replace(chunk_config(name, m, str(tmp_path / f"{w}.txt"), **fusion),
                                pose_init="velocity") for w in ("frame", "chunk")]
    seq, fuse_seq = per_frame(cfgs[0], depths, rgbs)
    chk = new_recon(cfgs[1], chunk_metrics=True)
    chk.process_frame(depths[0], rgbs[0], timestamp=0.0)
    stats = chk.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]),
                              timestamps=[float(i) for i in range(1, 7)])
    chk.close()
    assert [s.index for s in stats] == list(range(2, 8)) and chk.frame_num == 7
    assert [frame_tuple(s) for s in stats] == [frame_tuple(s) for s in seq.stats[1:]]
    assert stats[3].rejected and not any(s.rejected for i, s in enumerate(stats) if i != 3)
    assert chk.chunk_fuse_stats == fuse_seq[1:]
    assert chk.last_fuse_stats == fuse_seq[-1] and fuse_seq[-1].overflow == 0
    assert_bitwise(seq, chk)
    with open(tmp_path / "frame.txt") as a, open(tmp_path / "chunk.txt") as b:
        assert a.read() == b.read()
    assert all(s.fuse_ms > 0 for s in stats if not s.rejected)
    assert all(s.fuse_ms == 0 for s in stats if s.rejected)
    assert all(s.track_ms > 0 and s.preprocess_ms > 0 for s in stats)


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_chunk_matches_jax_chunk(name, m, fusion):
    """The port's process_chunk against the JAX package's on the same numpy
    frames (frame 4 all NaN): equal rejection flags and GN iterations, poses
    to 1e-4, the bf16 grids as test_torch_slice.py."""
    depths, rgbs = make_frames(7, nan_frame=4)
    rj = JReconstruction(CAM, chunk_config(name, m, package=jpreset, **fusion),
                         initial_pose=_orbit(7, dist=2.45)[0])
    rj.chunk_phase_metrics = False
    rt = new_recon(chunk_config(name, m, **fusion))
    for r in (rj, rt):
        r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    sj = rj.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    st = rt.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    assert [(s.rejected, s.gn_iterations) for s in st] == [
        (s.rejected, s.gn_iterations) for s in sj]
    assert st[3].rejected
    np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-4)
    np.testing.assert_allclose(rt.pose.R.numpy(), np.asarray(rj.pose.R), atol=1e-4)
    gt, gj = rt.grid, rj.grid
    W_j = np.asarray(gj.W)
    np.testing.assert_array_equal(gt.W.numpy() > 0, W_j > 0)
    np.testing.assert_allclose(gt.W.numpy(), W_j, rtol=2 ** -7)
    seen = W_j > 0
    np.testing.assert_allclose(gt.D.numpy()[seen], np.asarray(gj.D)[seen],
                               atol=2 * PARAMS.delta / 128)
    np.testing.assert_allclose(gt.Wc.numpy(), np.asarray(gj.Wc), rtol=2 ** -7)


def test_uint16_chunk_decodes_as_the_host():
    """TUM uint16 depth: the device decode equals the per-frame path's
    numpy decode bit for bit (directly, and through a chunk against the
    per-frame loop on the same uint16 frames), and the chunk's pose stays
    within 2e-3 m of the float frames' (0.2 mm quantization)."""
    depths, rgbs = make_frames(4)
    raw = [np.where(np.isfinite(d), np.round(d * 5000.0), 0).astype(np.uint16) for d in depths]
    host = raw[1].astype(np.float32) / 5000.0
    host[raw[1] == 0] = np.nan
    dev = decode_tum_depth(torch.from_numpy(raw[1].view(np.int16)), torch.tensor(5000.0))
    np.testing.assert_array_equal(dev.numpy().view(np.int32), host.view(np.int32))
    cfg = chunk_config("tum256", 48)
    seq, _ = per_frame(cfg, raw, rgbs)
    chk, flt = new_recon(cfg), new_recon(cfg)
    for r, frames in ((chk, raw), (flt, depths)):
        r.process_frame(frames[0], rgbs[0], timestamp=0.0)
        r.process_chunk(np.stack(frames[1:]), np.stack(rgbs[1:]))
    assert [frame_tuple(s) for s in chk.stats] == [frame_tuple(s) for s in seq.stats]
    assert_bitwise(seq, chk)
    assert float((chk.pose.t - flt.pose.t).norm()) < 2e-3


@pytest.mark.parametrize("container", ["numpy", "torch"])
def test_wire_formats_decode_alike_per_frame_and_chunked(container):
    """TUM uint16 depth and uint8 color as numpy arrays or as torch tensors
    (torch.uint16 / torch.uint8): process_frame gives, bit for bit, what it
    gives on the host's float32 decode of the same frames (raw / 5000 with
    NaN at 0, raw / 255), and process_chunk on the same container equals
    it. color_every is 1, so every frame fuses its colors."""
    depths, rgbs = make_frames(4)
    rng = np.random.default_rng(2)
    raw_d = [np.where(np.isfinite(d), np.round(d * 5000.0), 0).astype(np.uint16) for d in depths]
    raw_c = [rng.integers(0, 256, size=d.shape + (3,), dtype=np.uint8) for d in depths]
    host_d = []
    for r in raw_d:
        d = r.astype(np.float32) / 5000.0
        d[r == 0] = np.nan
        host_d.append(d)
    host_c = [c.astype(np.float32) / 255.0 for c in raw_c]
    cfg = chunk_config("tum256", 48, color_every=1)
    ref, _ = per_frame(cfg, host_d, host_c)
    assert not any(s.rejected for s in ref.stats) and ref.stats[-1].num_valid > 100
    if container == "torch":
        raw_d = [torch.from_numpy(r) for r in raw_d]
        raw_c = [torch.from_numpy(c) for c in raw_c]
        assert raw_d[0].dtype == torch.uint16 and raw_c[0].dtype == torch.uint8
        stack = torch.stack
    else:
        stack = np.stack
    seq, _ = per_frame(cfg, raw_d, raw_c)
    assert [frame_tuple(s) for s in seq.stats] == [frame_tuple(s) for s in ref.stats]
    assert_bitwise(ref, seq)
    chk = new_recon(cfg)
    chk.process_frame(raw_d[0], raw_c[0], timestamp=0.0)
    chk.process_chunk(stack(raw_d[1:]), stack(raw_c[1:]))
    assert [frame_tuple(s) for s in chk.stats] == [frame_tuple(s) for s in ref.stats]
    assert_bitwise(ref, chk)
    assert int((ref.brick_grid.C != new_recon(cfg).brick_grid.C).sum()) > 0


def test_color_every_chunk_off_cadence():
    """tum256 (color_every 2) with uint8 color: two frames per frame, then a
    chunk that starts off the cadence (absolute frames 3-5: color on 4 only)
    and an aligned one (6-7): the rows, color lanes included, equal the
    per-frame loop's."""
    depths, rgbs = make_frames(7)
    rgbs = [np.round(c * 255.0).astype(np.uint8) for c in rgbs]
    assert color_cadence(3, 3, True, 2) == [False, True, False]
    assert color_cadence(3, 3, False, 2) == [False] * 3
    cfg = chunk_config("tum256", 48)
    seq, _ = per_frame(cfg, depths, rgbs)
    chk = new_recon(cfg)
    for i in range(2):
        chk.process_frame(depths[i], rgbs[i], timestamp=float(i))
    chk.process_chunk(np.stack(depths[2:5]), np.stack(rgbs[2:5]))
    chk.process_chunk(np.stack(depths[5:]), np.stack(rgbs[5:]))
    assert [frame_tuple(s) for s in chk.stats] == [frame_tuple(s) for s in seq.stats]
    assert_bitwise(seq, chk)
    assert int((seq.brick_grid.C != new_recon(cfg).brick_grid.C).sum()) > 0


def test_run_chunk_odd_tail(tmp_path):
    """run(chunk=3) over nine frames: frame 0 per frame, two chunks of
    three, and the odd tail of two per frame; equal to run() per frame,
    with one metrics line and one trajectory line per frame."""
    depths, rgbs = make_frames(9)
    frames = [TUMFrame(timestamp=10.0 + i, depth=d, rgb=c)
              for i, (d, c) in enumerate(zip(depths, rgbs))]
    runs = {}
    for chunk in (0, 3):
        cfg = chunk_config("tum256", 48, str(tmp_path / f"traj{chunk}.txt"))
        r = new_recon(cfg)
        calls = []
        process_chunk = r.process_chunk
        r.process_chunk = lambda *a, **k: calls.append(len(a[0])) or process_chunk(*a, **k)
        log = str(tmp_path / f"metrics{chunk}.jsonl")
        assert r.run(iter(frames), chunk=chunk, metrics_log=log) is r.stats
        r.close()
        runs[chunk] = (r, calls, log)
    (seq, calls0, log0), (chk, calls3, log3) = runs[0], runs[3]
    assert calls0 == [] and calls3 == [3, 3]
    assert [frame_tuple(s) for s in chk.stats] == [frame_tuple(s) for s in seq.stats]
    assert [s.timestamp for s in chk.stats] == [10.0 + i for i in range(9)]
    assert_bitwise(seq, chk)
    with open(log3) as f:
        lines = [json.loads(x) for x in f]
    assert [x["index"] for x in lines] == list(range(1, 10))
    with open(tmp_path / "traj0.txt") as a, open(tmp_path / "traj3.txt") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", ["no_bootstrap", "flat"])
def test_process_chunk_preconditions(mode):
    cfg = chunk_config("tum256", 48)
    if mode == "flat":
        cfg = dataclasses.replace(cfg, fusion=cfg.fusion._replace(
            mode="bricked", brick_merge="pallas", brick_cap=256))
    depths, _ = make_frames(2)
    r = new_recon(cfg)
    if mode == "flat":
        r.process_frame(depths[0], timestamp=0.0)
    with pytest.raises(ValueError):
        r.process_chunk(np.stack(depths))
    if mode == "flat":  # run(chunk=N) falls back to per frame, with a warning
        with pytest.warns(RuntimeWarning):
            r.run([TUMFrame(1.0, depths[1], None)], chunk=2)
        assert r.frame_num == 2


def test_grid_setter_drops_chunk_steps():
    depths, rgbs = make_frames(5)
    cfg = chunk_config("tum256", 48)
    seq, _ = per_frame(cfg, depths, rgbs)
    r = new_recon(cfg)
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    r.process_chunk(np.stack(depths[1:3]), np.stack(rgbs[1:3]))
    assert r._chunk_steps is not None
    r.grid = r.grid
    assert r._chunk_steps is None
    r.process_chunk(np.stack(depths[3:]), np.stack(rgbs[3:]))
    assert_bitwise(seq, r)


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_all_nan_frame_fuses_nothing(name, m, fusion):
    """Fusion of an all-NaN frame, with color, into rows fused from a real
    frame leaves D, W and the color lanes bitwise unchanged."""
    cfg = chunk_config(name, m, **fusion)
    depths, rgbs = make_frames(2)
    r = new_recon(cfg)
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    bg = r.brick_grid
    before = [x.clone() for x in (bg.D, bg.W, bg.C)]
    assert int((bg.W > 0).sum()) > 1000
    nan = torch.full((CAM.height, CAM.width), float("nan"))
    pts, nrm = preprocess_frame(nan, cam=CAM, bilateral_mode=cfg.bilateral_mode)
    pose = pose_from_numpy(_orbit(7, dist=2.45)[1].R, _orbit(7, dist=2.45)[1].t, device="cpu")
    counts = fuse_frame_brickmajor_core(bg, pose, pts, nrm, torch.from_numpy(rgbs[1]),
                                        params=cfg.grid, cam=CAM, cfg=cfg.fusion,
                                        bs=cfg.fusion.brick_shape, cap=cfg.fusion.brick_cap)
    assert counts[1] == 0  # no FREE brick
    for a, b in zip(before, (bg.D, bg.W, bg.C)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_jax(delta):
    rng = np.random.default_rng(5)
    stamps = 10.0 + 0.1 * np.arange(15)
    q = rng.normal(size=(15, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.cumsum(rng.normal(scale=0.02, size=(15, 3)), axis=0)
    qe = q + rng.normal(scale=0.01, size=q.shape)
    te = t + rng.normal(scale=0.005, size=t.shape)
    ours = rpe_rmse(Trajectory(stamps + 0.004, te, qe), Trajectory(stamps, t, q), delta=delta)
    theirs = jrpe_rmse(JTrajectory(stamps + 0.004, te, qe), JTrajectory(stamps, t, q),
                       delta=delta)
    assert ours == theirs and 0.0 < ours[0] < 0.05 and 0.0 < ours[1] < 0.1
    assert np.isnan(rpe_rmse(Trajectory(stamps[:1], t[:1], q[:1]),
                             Trajectory(stamps, t, q))[0])
