"""Checkpoint and resume of the reconstruction state (counterpart of
tracking_sdf_tpu.pipeline.checkpoint, same files: either package loads what
the other wrote).

A checkpoint is a directory with ``state.npz`` (the six dense float32 grid
leaves ``grid_D`` ... ``grid_Wc``, ``pose_R``, ``pose_t``, optionally
``pose_prev_R`` / ``pose_prev_t``, and ``frame_num``) and ``meta.json``, a
readable mirror of the counter. Each file is written to a temporary name and
moved into place with ``os.replace``; the counter rides inside the npz so
that grid and counter change in one atomic step.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid

_STATE_FILE = "state.npz"
_META_FILE = "meta.json"


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path: str, grid: TSDFGrid, pose: Pose, frame_num: int,
                    extra: Optional[dict] = None,
                    pose_prev: Optional[Pose] = None) -> None:
    """Write a checkpoint directory. ``pose_prev`` keeps the
    constant-velocity carry, so a resumed run equals an uninterrupted one."""
    os.makedirs(path, exist_ok=True)
    arrays = {f"grid_{name}": _np(getattr(grid, name)) for name in FIELDS}
    arrays["pose_R"], arrays["pose_t"] = _np(pose.R), _np(pose.t)
    if pose_prev is not None:
        arrays["pose_prev_R"], arrays["pose_prev_t"] = _np(pose_prev.R), _np(pose_prev.t)
    arrays["frame_num"] = np.int64(frame_num)
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    tmp_meta = os.path.join(path, _META_FILE + ".tmp")
    with open(tmp_meta, "w") as f:
        json.dump({"frame_num": int(frame_num), **(extra or {})}, f)
    os.replace(tmp_meta, os.path.join(path, _META_FILE))


def load_checkpoint(path: str, *, device
                    ) -> Tuple[TSDFGrid, Pose, int, dict, Optional[Pose]]:
    """Read a checkpoint directory onto ``device``:
    (grid, pose, frame_num, meta, pose_prev)."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    with np.load(os.path.join(path, _STATE_FILE)) as z:
        grid = TSDFGrid(**{name: t(z[f"grid_{name}"]) for name in FIELDS})
        pose = Pose(t(z["pose_R"]), t(z["pose_t"]))
        pose_prev = None
        if "pose_prev_R" in z:
            pose_prev = Pose(t(z["pose_prev_R"]), t(z["pose_prev_t"]))
        frame_in_npz = int(z["frame_num"]) if "frame_num" in z else None
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    meta_frame = int(meta.pop("frame_num"))
    # the npz is the source of truth; older checkpoints lack the counter there
    frame_num = frame_in_npz if frame_in_npz is not None else meta_frame
    return grid, pose, frame_num, meta, pose_prev


def exists(path: str) -> bool:
    return (os.path.exists(os.path.join(path, _STATE_FILE))
            and os.path.exists(os.path.join(path, _META_FILE)))
