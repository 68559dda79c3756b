"""``--debug-nans`` (utils.debug_nans) on the CPU: the grid's and the pose's
invariants checked after every frame.

The JAX flag sets ``jax_debug_nans``, which traps the NaN sentinels that the
system carries on purpose and so stops every run at frame 0 (ROADMAP fault
R6); the port checks the invariants instead, and is not held to the JAX
package here. On the sizes of tests/test_torch_chunk.py (the presets at m=48
and m=64) and tests/test_torch_parallel.py (two ThreadMesh ranks):
  * a clean run with the switch on is the run with it off, bit for bit (rows
    and poses), per frame in every fusion layout and chunked;
  * a NaN injected into a row that K2's plain version listed (D where
    W > 0, W, color where Wc > 0) or into the pose that a frame fuses
    with raises FloatingPointError naming that frame, the invariant and
    the count of bad values, per frame and in a chunk (after its one read);
  * a grid assigned with a bad voxel raises at the setter; a rejected
    all-NaN frame raises nothing; both ThreadMesh ranks raise at the same
    frame; the CLI with --debug-nans exits 0 on a clean sequence.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from test_torch_chunk import chunk_config, make_frames, new_recon
from test_torch_cli import Run, camera_arg, sequence  # noqa: F401 (a fixture)
from test_torch_parallel import _orbit, _runner_cfg, orbit, run_ranks  # noqa: F401
from test_torch_parallel import CAM as PCAM
from tracking_sdf_tpu_torch import cli
from tracking_sdf_tpu_torch.core.lie import Pose, pose_from_numpy
from tracking_sdf_tpu_torch.fusion import brick_fuse
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.grid.grid import FIELDS
from tracking_sdf_tpu_torch.pipeline import runner
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.utils import debug_nans

torch.set_num_threads(2)

N = 5  # frames: frame 1 bootstraps, then 4 tracked (per frame or one chunk of 4)
LAYOUTS = {
    "brickmajor": {},
    "packed": {"mode": "packed"},
    "dense": {"mode": "dense"},
    "bricked": {"mode": "bricked", "brick_merge": "xla", "brick_shape": (1, 8, 48)},
}


def _config(layout, name="tum256", m=48):
    cfg = chunk_config(name, m)
    return dataclasses.replace(cfg, fusion=cfg.fusion._replace(**LAYOUTS[layout]))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int16)


def _loop(cfg, chunked, depths, rgbs):
    r = new_recon(cfg)
    r.process_frame(depths[0], rgbs[0], timestamp=0.0)
    if chunked:
        r.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    else:
        for i in range(1, len(depths)):
            r.process_frame(depths[i], rgbs[i], timestamp=float(i))
    return r


def _leaves(r):
    if r.brick_grid is not None:
        return {k: _bits(getattr(r.brick_grid, k)) for k in "DWC"}
    return {k: _bits(getattr(r.grid, k)) for k in FIELDS}


@pytest.mark.parametrize("layout,chunked", [("brickmajor", False), ("brickmajor", True),
                                            ("packed", False), ("dense", False),
                                            ("bricked", False)])
def test_clean_run_is_the_run_without_the_switch(layout, chunked):
    depths, rgbs = make_frames(N)
    cfg = _config(layout)
    off = _loop(cfg, chunked, depths, rgbs)
    assert not debug_nans.enabled()
    with debug_nans.switch():
        on = _loop(cfg, chunked, depths, rgbs)
    assert not debug_nans.enabled()
    a, b = _leaves(off), _leaves(on)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(on.pose.R, off.pose.R) and torch.equal(on.pose.t, off.pose.t)
    # GN iterations, valid pixels, mean |residual|, rejected (not the times)
    assert [dataclasses.astuple(s)[4:8] for s in on.stats] == [
        dataclasses.astuple(s)[4:8] for s in off.stats]
    assert not any(s.rejected for s in on.stats)


def _observed_voxel(W, ids, weights=None):
    """(row, column) of the first voxel with a positive weight (``W`` or
    ``weights``) in a listed row."""
    w = W if weights is None else weights
    listed = ids[ids < W.shape[0]].long()
    row = int(listed[(w[listed] > 0).any(dim=1)][0])
    return row, int(torch.nonzero(w[row] > 0)[0, 0])


def _poison(what):
    """A K2 plain version that, on its ``at``-th call, writes one bad value
    into a listed row after fusing it."""
    real = brick_fuse.brick_fuse_rows_reference
    calls = []

    def spy(D, W, C, ids, pix, pose, *, at, **kw):
        real(D, W, C, ids, pix, pose, **kw)
        calls.append(1)
        if len(calls) != at:
            return
        if what == "D":
            D[_observed_voxel(W, ids)] = float("nan")
        elif what == "W":
            W[_observed_voxel(W, ids)] = float("nan")
        else:  # R of a voxel whose color weight is positive
            R, _, _, Wc = tbm.unpack_color(C, D.dtype, W.dtype, D.shape[1])
            row, col = _observed_voxel(W, ids, Wc)
            R = R[row].clone()
            R[col] = float("nan")
            C[row, :R.numel() * R.element_size() // 2] = R.view(torch.int16)
    return spy


INVARIANT = {"D": "NaN in D where W > 0", "W": "W not finite", "color": "color not finite",
             "pose": "pose (R, t) not finite"}


@pytest.mark.parametrize("chunked", [False, True], ids=["per_frame", "chunked"])
@pytest.mark.parametrize("what", ["D", "W", "color", "pose"])
def test_injected_fault_raises_at_its_frame(what, chunked, monkeypatch):
    """The fault is injected in the 4th fused frame (call 4: frame 1 is the
    bootstrap, frames 2-5 tracked, chunked as one chunk of 4)."""
    depths, rgbs = make_frames(N)
    cfg = _config("brickmajor")
    cfg = dataclasses.replace(cfg, fusion=cfg.fusion._replace(color_every=1))
    if what == "pose":
        real, calls = runner.fuse_frame_brickmajor_core, []

        def core(bgrid, pose, *a, **kw):
            calls.append(1)
            if len(calls) == 4:  # the pose the frame fuses with
                pose = Pose(pose.R * float("nan"), pose.t)
            return real(bgrid, pose, *a, **kw)
        monkeypatch.setattr(runner, "fuse_frame_brickmajor_core", core)
    else:
        spy = _poison(what)
        monkeypatch.setattr(brick_fuse, "brick_fuse_rows_reference",
                            lambda *a, **kw: spy(*a, at=4, **kw))
    with debug_nans.switch(), pytest.raises(FloatingPointError) as err:
        _loop(cfg, chunked, depths, rgbs)
    msg = str(err.value)
    assert re.search(r"\bframe 4\b", msg) and INVARIANT[what] in msg, msg
    count = re.search(r"\((\d+) values\)", msg)
    assert count and int(count.group(1)) >= 1, msg


def test_grid_assignment_with_a_bad_voxel_raises():
    r = new_recon(_config("brickmajor"))
    g = r.grid
    g.W[3, 4, 5] = 1.0
    g.D[3, 4, 5] = float("nan")
    r.grid = g  # switch off: taken as it is
    with debug_nans.switch(), pytest.raises(FloatingPointError, match="assigned grid"):
        r.grid = g
    g.D[3, 4, 5] = 0.01
    g.Wc[1, 1, 1] = float("inf")
    with debug_nans.switch(), pytest.raises(FloatingPointError, match="color"):
        r.grid = g


@pytest.mark.parametrize("chunked", [False, True], ids=["per_frame", "chunked"])
def test_rejected_all_nan_frame_does_not_raise(chunked):
    depths, rgbs = make_frames(N, nan_frame=3)
    with debug_nans.switch():
        r = _loop(_config("brickmajor"), chunked, depths, rgbs)
    assert [s.rejected for s in r.stats] == [False, False, False, True, False]


def test_thread_mesh_ranks_raise_at_the_same_frame(orbit, monkeypatch):  # noqa: F811
    """A NaN written into the second rank's rows only: both ranks raise at
    that frame (the counts' all_reduce carries the invariants)."""
    cfg = _runner_cfg(storage_dtype="bfloat16", fuse_color=True, color_every=2)
    rgb = np.full(orbit[0].shape + (3,), 0.5, np.float32)
    pose0 = pose_from_numpy(_orbit(0).R, _orbit(0).t, device="cpu")
    real = brick_fuse.brick_fuse_rows_reference
    calls = []

    def spy(D, W, C, ids, pix, pose, **kw):
        real(D, W, C, ids, pix, pose, **kw)
        if kw["i_offset"] > 0:
            calls.append(1)
            if len(calls) == 3:
                D[_observed_voxel(W, ids)] = float("nan")
    monkeypatch.setattr(brick_fuse, "brick_fuse_rows_reference", spy)

    def run(mesh):
        r = Reconstruction(PCAM, cfg, initial_pose=pose0, mesh=mesh)
        try:
            for k, d in enumerate(orbit):
                r.process_frame(d, rgb, timestamp=float(k))
        except FloatingPointError as e:
            return str(e)
        return None

    with debug_nans.switch():
        msgs = run_ranks(2, run)
    assert msgs[0] is not None and msgs[0] == msgs[1], msgs
    assert re.search(r"\bframe 3\b", msgs[0]) and "NaN in D" in msgs[0]


def test_cli_debug_nans_exits_0(sequence, tmp_path, monkeypatch):  # noqa: F811
    root, stats = sequence
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval",
                    "--debug-nans", "--chunk", "4"], tmp_path, "dn", monkeypatch)
    assert got.rc == 0, got.stderr
    assert got.summary["ate_rmse_m"] < 0.05
    assert not debug_nans.enabled()  # the switch held for the run only
