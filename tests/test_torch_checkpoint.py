"""Checkpoints of the port: a resumed run continues bit for bit, and the
files cross between the port and the JAX package in both directions.

Sizes of test_torch_chunk.py (the presets at m=48 / m=64 over a 2 m cube, a
96x72 camera). Tolerance: none; everything here is bitwise (bf16 rows
through the dense float32 leaves and back, NaN sentinels included).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_chunk import (
    PRESETS, assert_bitwise, chunk_config, frame_tuple, initial_pose, make_frames, new_recon)
from test_torch_slice import CAM, _orbit
from tracking_sdf_tpu.config import preset as jpreset
from tracking_sdf_tpu.pipeline import Reconstruction as JReconstruction
from tracking_sdf_tpu.pipeline import checkpoint as jckpt
from tracking_sdf_tpu_torch.data.tum import TUMFrame
from tracking_sdf_tpu_torch.grid.grid import FIELDS
from tracking_sdf_tpu_torch.pipeline import checkpoint as ckpt
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

torch.set_num_threads(2)


def velocity(cfg):
    return dataclasses.replace(cfg, pose_init="velocity")


def feed(r, depths, rgbs, start, stop, chunk):
    """Frames [start, stop) per frame, or in chunks of ``chunk`` (frame 0
    always per frame)."""
    i = start
    while i < stop:
        if chunk and i > 0 and i + chunk <= stop:
            r.process_chunk(np.stack(depths[i:i + chunk]), np.stack(rgbs[i:i + chunk]),
                            timestamps=[float(k) for k in range(i, i + chunk)])
            i += chunk
        else:
            r.process_frame(depths[i], rgbs[i], timestamp=float(i))
            i += 1


@pytest.mark.parametrize("chunk", [0, 2], ids=["per_frame", "chunk2"])
@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_resume_continues_bitwise(tmp_path, name, m, fusion, chunk):
    """3 frames, save, restore into a fresh Reconstruction, 4 more: rows,
    pose, the velocity carry, FrameStats and the trajectory file equal the
    uninterrupted run's."""
    depths, rgbs = make_frames(7)
    cfgs = {k: velocity(chunk_config(name, m, str(tmp_path / f"{k}.txt"), **fusion))
            for k in ("whole", "resumed")}
    whole = new_recon(cfgs["whole"])
    feed(whole, depths, rgbs, 0, 7, chunk)
    whole.close()

    first = new_recon(cfgs["resumed"])
    feed(first, depths, rgbs, 0, 3, chunk)
    path = str(tmp_path / "ck")
    first.save_checkpoint(path)
    first.close()
    assert ckpt.exists(path) and not ckpt.exists(str(tmp_path))
    assert sorted(os.listdir(path)) == ["meta.json", "state.npz"]  # no temp file left

    second = new_recon(cfgs["resumed"])
    second.restore_checkpoint(path)
    assert second.frame_num == 3 and second._chunk_steps is None
    assert_bitwise(first, second)
    feed(second, depths, rgbs, 3, 7, chunk)
    second.close()
    assert_bitwise(whole, second)
    assert torch.equal(whole._pose_prev.R, second._pose_prev.R)
    assert [frame_tuple(s) for s in second.stats] == [frame_tuple(s) for s in whole.stats[3:]]
    with open(tmp_path / "whole.txt") as a, open(tmp_path / "resumed.txt") as b:
        lines = a.read()
        assert lines == b.read() and len(lines.splitlines()) == 7


def test_resume_flat_layout(tmp_path):
    """The flat bricked layout keeps its dense grid: restore hands it back."""
    depths, rgbs = make_frames(5)
    cfg = chunk_config("tum256", 48)
    cfg = dataclasses.replace(cfg, fusion=cfg.fusion._replace(
        mode="bricked", brick_merge="pallas", brick_cap=256))
    whole = new_recon(cfg)
    feed(whole, depths, rgbs, 0, 5, 0)
    first = new_recon(cfg)
    feed(first, depths, rgbs, 0, 3, 0)
    first.save_checkpoint(str(tmp_path / "ck"))
    second = new_recon(cfg)
    second.restore_checkpoint(str(tmp_path / "ck"))
    feed(second, depths, rgbs, 3, 5, 0)
    for k in FIELDS:
        assert torch.equal(getattr(whole.grid, k), getattr(second.grid, k)), k
    assert torch.equal(whole.pose.t, second.pose.t) and torch.equal(whole.pose.R, second.pose.R)


@pytest.mark.parametrize("chunk", [0, 2], ids=["per_frame", "chunk2"])
def test_run_saves_on_the_latest_frame_and_resumes(tmp_path, chunk):
    """run(checkpoint_every=3): per frame it saves at frames 3 and 6; in
    chunks of 2 (frames 2-3, 4-5, 6-7 after the first) only frame 3 is the
    newest frame when its stats come, so frame 6 saves nothing. A second
    run() restored from the file skips the frames done and ends equal to
    one run over all frames."""
    depths, rgbs = make_frames(7)
    frames = [TUMFrame(timestamp=20.0 + i, depth=d, rgb=c)
              for i, (d, c) in enumerate(zip(depths, rgbs))]
    path = str(tmp_path / "ck")
    whole = new_recon(chunk_config("tum256", 48, str(tmp_path / "whole.txt")))
    whole.run(frames, chunk=chunk)
    whole.close()

    cfg = chunk_config("tum256", 48, str(tmp_path / "parts.txt"))
    first = new_recon(cfg)
    saved = []
    save = first.save_checkpoint
    first.save_checkpoint = lambda p: saved.append(first.frame_num) or save(p)
    first.run(frames, chunk=chunk, checkpoint_every=3, checkpoint_path=path)
    first.close()
    assert saved == ([3] if chunk else [3, 6])
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == {"frame_num": saved[-1]}
    assert_bitwise(whole, first)

    second = new_recon(cfg)
    second.restore_checkpoint(path)
    second.run(frames, chunk=chunk, skip_frames=second.frame_num)
    second.close()
    assert second.frame_num == 7 and len(second.stats) == 7 - saved[-1]
    assert_bitwise(whole, second)
    with open(tmp_path / "whole.txt") as a, open(tmp_path / "parts.txt") as b:
        want, got = a.read().splitlines(), b.read().splitlines()
    # the first run wrote all 7 poses; the resumed run appended its own again
    assert got == want + want[saved[-1]:]


def jax_pair(name, m, fusion, n=3):
    """The same n frames through both packages' runners (velocity carry on)."""
    depths, rgbs = make_frames(n)
    rj = JReconstruction(CAM, velocity(chunk_config(name, m, package=jpreset, **fusion)),
                         initial_pose=_orbit(7, dist=2.45)[0])
    rt = new_recon(velocity(chunk_config(name, m, **fusion)))
    for i in range(n):
        rj.process_frame(depths[i], rgbs[i], timestamp=float(i))
        rt.process_frame(depths[i], rgbs[i], timestamp=float(i))
    return rj, rt


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, name, m, fusion):
    """A checkpoint the JAX package wrote loads into the port: the dense
    grid, the pose, the carry and the counter bit for bit."""
    rj, _ = jax_pair(name, m, fusion)
    path = str(tmp_path / "jax_ck")
    rj.save_checkpoint(path)
    rt = new_recon(velocity(chunk_config(name, m, **fusion)))
    rt.restore_checkpoint(path)
    assert rt.frame_num == rj.frame_num == 3
    gj, gt = rj.grid, rt.grid
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(gt, k).numpy().view(np.int32),
                                      np.asarray(getattr(gj, k)).view(np.int32), err_msg=k)
    np.testing.assert_array_equal(rt.pose.R.numpy(), np.asarray(rj.pose.R))
    np.testing.assert_array_equal(rt.pose.t.numpy(), np.asarray(rj.pose.t))
    np.testing.assert_array_equal(rt._pose_prev.t.numpy(), np.asarray(rj._pose_prev.t))
    assert rt.brick_grid.D.dtype == torch.bfloat16
    assert bool(torch.isnan(rt.brick_grid.D[rt.brick_grid.W == 0]).all())
    # and the port goes on from it
    depths, rgbs = make_frames(4)
    st = rt.process_frame(depths[3], rgbs[3], timestamp=3.0)
    assert not st.rejected and st.gn_iterations > 0


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_port_checkpoint_restores_in_jax(tmp_path, name, m, fusion):
    """The reverse: the JAX package loads what the port wrote."""
    _, rt = jax_pair(name, m, fusion)
    path = str(tmp_path / "port_ck")
    rt.save_checkpoint(path)
    rj = JReconstruction(CAM, velocity(chunk_config(name, m, package=jpreset, **fusion)),
                         initial_pose=_orbit(7, dist=2.45)[0])
    rj.restore_checkpoint(path)
    assert rj.frame_num == 3 and jckpt.exists(path)
    gj, gt = rj.grid, rt.grid
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(gj, k)).view(np.int32),
                                      getattr(gt, k).numpy().view(np.int32), err_msg=k)
    np.testing.assert_array_equal(np.asarray(rj.pose.R), rt.pose.R.numpy())
    np.testing.assert_array_equal(np.asarray(rj.pose.t), rt.pose.t.numpy())
    np.testing.assert_array_equal(np.asarray(rj._pose_prev.R), rt._pose_prev.R.numpy())


def test_checkpoint_file_layout(tmp_path):
    """state.npz holds the six float32 leaves, the pose and the counter;
    pose_prev is optional; an older file without the counter falls back to
    meta.json; ``extra`` lands in meta."""
    depths, rgbs = make_frames(2)
    r = new_recon(chunk_config("tum256", 48))
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, r.grid, r.pose, 1, extra={"note": "x"})
    with np.load(os.path.join(path, "state.npz")) as z:
        keys = set(z.files)
        assert keys == {f"grid_{k}" for k in FIELDS} | {"pose_R", "pose_t", "frame_num"}
        assert all(z[f"grid_{k}"].dtype == np.float32 and z[f"grid_{k}"].shape == (48,) * 3
                   for k in FIELDS)
        arrays = {k: z[k] for k in z.files if k != "frame_num"}
    grid, pose, frame_num, meta, prev = ckpt.load_checkpoint(path, device="cpu")
    assert frame_num == 1 and meta == {"note": "x"} and prev is None
    assert torch.equal(grid.W, r.grid.W) and torch.equal(pose.t, r.pose.t)
    with open(os.path.join(path, "state.npz"), "wb") as f:
        np.savez(f, **arrays)  # as written before the counter moved into the npz
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"frame_num": 9}, f)
    assert ckpt.load_checkpoint(path, device="cpu")[2] == 9


def test_restore_keeps_the_trajectory_written_before(tmp_path):
    """TrajectoryWriter.started / set_append: a restored runner appends, a
    fresh one truncates, and the switch is refused after the first write."""
    depths, rgbs = make_frames(3)
    traj = str(tmp_path / "t.txt")
    cfg = chunk_config("tum256", 48, traj)
    a = new_recon(cfg)
    assert not a._writer.started
    for i in range(2):
        a.process_frame(depths[i], rgbs[i], timestamp=float(i))
    assert a._writer.started
    with pytest.raises(RuntimeError):
        a._writer.set_append(True)
    a.save_checkpoint(str(tmp_path / "ck"))
    a.close()
    b = Reconstruction(CAM, cfg, device="cpu", initial_pose=initial_pose())
    b.restore_checkpoint(str(tmp_path / "ck"))
    b.process_frame(depths[2], rgbs[2], timestamp=2.0)
    b.close()
    with open(traj) as f:
        assert [float(x.split()[0]) for x in f] == [0.0, 1.0, 2.0]
    c = new_recon(cfg)
    c.process_frame(depths[0], rgbs[0], timestamp=0.0)
    c.close()
    with open(traj) as f:
        assert len(f.readlines()) == 1
