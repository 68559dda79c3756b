"""The plain frame step that decides ``correct``, and the state it carries.

A frame, as the configuration states it: decode the TUM wire formats,
preprocess, track from the previous pose (frame 1 on) by the configured
Jacobian (``analytic``: reference.track; ``central``: the 13-probe scheme
of reference.track_central), reject the frame when the track ends with
fewer than ``min_valid_pixels`` valid queries, a mean |residual| above
``max_mean_residual`` or a non-finite pose (the pose is kept and nothing
is fused), else fuse it at the tracked pose, with color on the frames
whose 1-based number is a multiple of ``color_every``.

``store`` is the storage precision of D, W and the colors: the
configuration's (``bfloat16``) for the reference, the next one below
(``float8_e4m3fn``) for the control.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from reference import fuse, preprocess, track, track_central
from reference.lie import Pose

STORES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
JACOBIANS = ("analytic", "central")


class FrameResult(NamedTuple):
    pose: Pose
    rejected: bool
    iterations: int
    counts: Optional[list]


def rounding(name: str):
    """x -> x rounded to the storage dtype ``name``, held as float32."""
    dt = STORES[name]
    return lambda x: x.to(dt).to(torch.float32)


def check_supported(cfg: dict) -> None:
    """The reference runs the configuration's modes as stated and no other:
    raises NotImplementedError naming every mode it does not run."""
    f, t, p = cfg["fusion"], cfg["tracking"], cfg["pipeline"]
    want = dict(mode="brickmajor", distance="point_to_point", weighting="exponential",
                fuse_color=True, free_fold=True, sat_skip=False)
    bad = [k for k, v in want.items() if f[k] != v]
    bad += [k for k, v in dict(convergence="norm", pose_update="se3").items() if t[k] != v]
    if t["jacobian"] not in JACOBIANS:
        bad.append("jacobian")
    bad += [k for k, v in dict(bilateral_filter=True, bilateral_mode="separable",
                               pose_init="previous", use_groundtruth=False).items() if p[k] != v]
    if bad:
        raise NotImplementedError(f"the plain reference does not run {bad}")


def leaves_from_rows(D, W, C, bv: int) -> dict:
    """The plain leaves (float32, (NB, BV)) of the program's brick rows: D
    and W as stored, and the packed color lanes [R | G | B | Wc] of C read
    back through the storage dtypes."""
    vd, wd = D.dtype, W.dtype
    lv, lw = bv * vd.itemsize // 2, bv * wd.itemsize // 2
    C = C.contiguous()
    return {"D": D.float(), "W": W.float(),
            "R": C[:, :lv].contiguous().view(vd).float(),
            "G": C[:, lv:2 * lv].contiguous().view(vd).float(),
            "B": C[:, 2 * lv:3 * lv].contiguous().view(vd).float(),
            "Wc": C[:, 3 * lv:3 * lv + lw].contiguous().view(wd).float()}


def empty_leaves(cfg: dict, device, store) -> dict:
    m = cfg["grid"]["m"]
    bs = cfg["fusion"]["brick_shape"]
    shape = ((m // bs[0]) * (m // bs[1]) * (m // bs[2]), bs[0] * bs[1] * bs[2])
    grey = store(torch.full(shape, 0.4, device=device))
    return {"D": torch.full(shape, float("nan"), device=device),
            "W": torch.zeros(shape, device=device), "R": grey, "G": grey.clone(),
            "B": grey.clone(), "Wc": torch.zeros(shape, device=device)}


class Reference:
    """The plain state (pose, leaves) and its frame step."""

    def __init__(self, cfg: dict, leaves: dict, pose: Pose, frame_num: int, store: str):
        check_supported(cfg)
        # float32 products in float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.cam = cfg["camera"]
        self.leaves = leaves
        self.pose = pose
        self.frame_num = frame_num  # frames processed so far
        self.store = rounding(store)
        dev = pose.R.device
        self._scale_d = torch.full((), 5000.0, device=dev)
        self._scale_c = torch.full((), 255.0, device=dev)

    def frame(self, depth16: torch.Tensor, rgb8: torch.Tensor) -> FrameResult:
        cfg = self.cfg
        grid, f, p = cfg["grid"], cfg["fusion"], cfg["pipeline"]
        self.frame_num += 1
        pts, nrm = preprocess.preprocess(preprocess.decode_depth(depth16, self._scale_d),
                                         self.cam)
        pose, iters, rejected = self.pose, 0, False
        if self.frame_num > 1:
            bs, tcfg, levels = tuple(f["brick_shape"]), cfg["tracking"], p["pyramid_levels"] or (1,)
            if tcfg["jacobian"] == "central":
                res = track_central.track(self.leaves["D"], self.leaves["W"], grid, bs, self.pose,
                                          pts, tcfg, levels)
            else:
                res = track.track(self.leaves["D"], grid, bs, self.pose, pts, tcfg, levels)
            iters = res.iterations
            mean_res = np.float32(res.sum_abs) / np.float32(max(res.num_valid, 1.0))
            finite = bool(torch.isfinite(res.pose.R).all() and torch.isfinite(res.pose.t).all())
            rejected = (res.num_valid < p["min_valid_pixels"] or not finite
                        or (p["max_mean_residual"] > 0 and mean_res > p["max_mean_residual"]))
            if not rejected:
                pose = res.pose
        counts = None
        if not rejected:
            ce = f["color_every"]
            rgb = (preprocess.decode_rgb(rgb8, self._scale_c)
                   if ce <= 1 or self.frame_num % ce == 0 else None)
            counts = fuse.fuse(self.leaves, pose, pts, nrm, rgb, grid, self.cam, f,
                               self.store).tolist()
        self.pose = pose
        return FrameResult(pose, rejected, iters, counts)
