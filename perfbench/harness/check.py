"""How ``correct`` is decided: the plain reference (perfbench/reference)
follows the program from the program's own state over a sample of the
window's frames, and from the empty grid over the bootstrap frame, and
each number below is held to its limit (limits/<cell>.json).

The reference can only follow the program step by step: a tracked,
fused sequence is a chain in which every frame reads the grid that all the
frames before it wrote, up to a session's length into it. So the sample
is a run of consecutive chunks drawn from the seed, and the program's state
before it (its brick rows, its pose) is copied when the window reaches it;
the reference works out the sample's frames again from that state and the
same staged inputs, and is compared with what the program's timed path
produced: each frame's pose as it lands in the trajectory file (with the
failure gate's verdict from the frame's record) and the rows after the
sample. The start is checked by itself: the bootstrap frame fused into the
empty grid, against the program's rows after it.

The numbers (a gap is |program - reference|):
  pose_t_max_mm    widest camera position gap over the sample's frames
  pose_r_max_mdeg  widest rotation gap angle over them, millidegrees,
                   between the quaternions (the program's as its trajectory
                   holds them; the reference's from its rotation by the same
                   conversion, since neither side keeps R orthonormal)
  d_mm         mean D gap over the voxels the sample updated (W changed in
               either) that both observe
  w            mean W gap over the voxels the sample updated
  rgb_255      mean color gap (R, G, B, in 1/255) over the voxels whose
               color weight the sample changed in either
  start_d_mm   mean D gap after the bootstrap frame over the voxels either observes
  start_w      mean W gap after it over those voxels
A frame that one side rejects and the other does not, or whose pose is
missing, makes the pose gaps infinite.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from reference.lie import Pose, quaternion_angle, quaternion_from_matrix
from reference.step import Reference, empty_leaves, leaves_from_rows, rounding

ROW_BLOCK = 1 << 14  # rows compared at a time


def read_trajectory(path: str, frames) -> Dict[int, tuple]:
    """The lines of ``frames`` (1-based frame numbers, the timestamps the
    run handed the program) of a TUM trajectory file: {frame: (t, q)}."""
    want = set(int(f) for f in frames)
    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 8 and int(round(float(parts[0]))) in want:
                v = [float(x) for x in parts[1:]]
                out[int(round(float(parts[0])))] = (np.array(v[:3]), np.array(v[3:]))
    return out


def _gaps(prog: dict, ref: dict, changed_w, changed_c):
    """Sums and counts of the D, W and color gaps over a block of rows."""
    obs_both = (prog["W"] > 0) & (ref["W"] > 0) & changed_w
    dd = torch.where(obs_both, (prog["D"] - ref["D"]).abs(), 0.0)
    dw = torch.where(changed_w, (prog["W"] - ref["W"]).abs(), 0.0)
    dc = sum(torch.where(changed_c, (prog[k] - ref[k]).abs(), 0.0) for k in "RGB") / 3.0
    return (dd.sum(dtype=torch.float64).item(), int(obs_both.sum()),
            dw.sum(dtype=torch.float64).item(), int(changed_w.sum()),
            dc.sum(dtype=torch.float64).item(), int(changed_c.sum()))


def grid_gaps(prog: dict, ref: dict, before: Optional[dict]) -> tuple:
    """(mean D gap m, mean W gap, mean color gap) over the voxels updated
    since ``before`` (every voxel either observes, with no ``before``)."""
    acc = np.zeros(6)
    n = prog["D"].shape[0]
    for r0 in range(0, n, ROW_BLOCK):
        sl = slice(r0, min(r0 + ROW_BLOCK, n))
        p = {k: v[sl] for k, v in prog.items()}
        q = {k: v[sl] for k, v in ref.items()}
        if before is None:
            cw = (p["W"] > 0) | (q["W"] > 0)
            cc = (p["Wc"] > 0) | (q["Wc"] > 0)
        else:
            b = {k: v[sl] for k, v in before.items()}
            cw = (p["W"] != b["W"]) | (q["W"] != b["W"])
            cc = (p["Wc"] != b["Wc"]) | (q["Wc"] != b["Wc"])
        acc += np.array(_gaps(p, q, cw, cc), dtype=np.float64)
    return (acc[0] / max(acc[1], 1), acc[2] / max(acc[3], 1), acc[4] / max(acc[5], 1))


class Sample:
    """What the check needs of the sample: the program's state before it
    (rows, pose, frames done), its staged inputs and its outputs."""

    def __init__(self, before_rows, pose: Pose, frame_num: int, depth16, rgb8,
                 after_rows, rejected: List[bool], counts: List[Optional[list]],
                 iterations: Optional[List[int]] = None, first_stamp: Optional[float] = None):
        self.before_rows = before_rows
        self.pose = pose
        self.frame_num = frame_num
        self.depth16, self.rgb8 = depth16, rgb8
        self.after_rows = after_rows
        self.rejected = rejected
        self.counts = counts
        self.iterations = iterations or [0] * len(rejected)
        self.first_stamp = int(first_stamp if first_stamp is not None else frame_num + 1)

    @property
    def frames(self) -> List[int]:
        """The trajectory timestamps the run handed the sample's frames."""
        return list(range(self.first_stamp, self.first_stamp + len(self.rejected)))


def reference_outputs(cfg: dict, sample: Sample, store: str) -> dict:
    """The sample's frames worked out again from the program's state before
    it, with values stored in ``store``: each kept frame's pose (t, q as
    float64), the gate's verdicts, the fusion counts, the leaves."""
    before = leaves_from_rows(*sample.before_rows, sample.before_rows[0].shape[1])
    ref = Reference(cfg, {k: v.clone() for k, v in before.items()}, sample.pose,
                    sample.frame_num, store)
    poses, rejected, counts, iters = {}, [], [], []
    for k, frame in enumerate(sample.frames):
        res = ref.frame(sample.depth16[k], sample.rgb8[k])
        rejected.append(res.rejected)
        counts.append(res.counts)
        iters.append(res.iterations)
        if not res.rejected:
            poses[frame] = (res.pose.t.double().cpu().numpy(),
                            quaternion_from_matrix(res.pose.R.cpu().numpy()))
    return dict(poses=poses, rejected=rejected, counts=counts, iterations=iters,
                leaves=ref.leaves, before=before)


def program_outputs(sample: Sample, trajectory: Dict[int, tuple]) -> dict:
    """The program's outputs over the sample: the poses of its trajectory
    file, its gate's verdicts and fusion counts from the frames' records, its rows after."""
    return dict(poses=dict(trajectory), rejected=list(sample.rejected), counts=list(sample.counts),
                iterations=list(sample.iterations),
                leaves=leaves_from_rows(*sample.after_rows, sample.after_rows[0].shape[1]))


def compare(prog: dict, ref: dict, frames: List[int]) -> dict:
    """The sample's numbers of ``prog`` against ``ref`` (both as
    reference_outputs gives them; ref's ``before`` is the state before)."""
    t_gap, r_gap = [], []
    for k, frame in enumerate(frames):
        if prog["rejected"][k] != ref["rejected"][k] or (
                not ref["rejected"][k] and frame not in prog["poses"]):
            t_gap.append(np.inf)
            r_gap.append(np.inf)
        elif not ref["rejected"][k]:
            (tp, qp), (tq, qq) = prog["poses"][frame], ref["poses"][frame]
            t_gap.append(np.linalg.norm(tp - tq) * 1e3)
            r_gap.append(np.degrees(quaternion_angle(qp, qq)) * 1e3)
    d, w, c = grid_gaps(prog["leaves"], ref["leaves"], ref["before"])
    # the frames that read above the trajectory file's rounding, for the log
    differ = [(frame, round(t, 6), round(r, 4), prog["iterations"][k], ref["iterations"][k],
               prog["counts"][k] == ref["counts"][k])
              for k, (frame, t, r) in enumerate(zip(frames, t_gap + [np.inf] * len(frames),
                                                    r_gap + [np.inf] * len(frames)))
              if t > 0.002 or r > 0.2 or prog["iterations"][k] != ref["iterations"][k]
              or prog["counts"][k] != ref["counts"][k]]
    return dict(differ=differ, d_mm=d * 1e3, w=w, rgb_255=c * 255.0, frames=len(frames),
                pose_t_max_mm=float(np.max(t_gap)) if t_gap else np.inf,
                pose_r_max_mdeg=float(np.max(r_gap)) if r_gap else np.inf,
                counts_equal=sum(int(a is not None and b is not None and list(a) == list(b))
                                 for a, b in zip(prog["counts"], ref["counts"])))


def start_leaves(cfg: dict, pose0: Pose, depth16, rgb8, store: str, device) -> dict:
    """The leaves after the bootstrap frame fused into the empty grid."""
    ref = Reference(cfg, empty_leaves(cfg, device, rounding(store)), pose0, 0, store)
    ref.frame(depth16, rgb8)
    return ref.leaves


def compare_start(cfg: dict, start_rows, ref_leaves: dict) -> dict:
    """The bootstrap numbers: ``start_rows`` = (ids, D, W, C), the rows
    (program's or another reference's) that hold an observed voxel after
    the bootstrap frame; every other row is as the empty grid holds it."""
    ids, D, W, C = start_rows
    ids = ids.to(torch.int64)
    rows = torch.unique(torch.cat([ids, torch.nonzero((ref_leaves["W"] > 0).any(1)).reshape(-1)]))
    grey = float(rounding(cfg["fusion"]["storage_dtype"])(torch.tensor(0.4)))
    shape = (rows.numel(), D.shape[1])
    prog = {k: torch.full(shape, v, device=D.device)
            for k, v in dict(D=float("nan"), W=0.0, R=grey, G=grey, B=grey, Wc=0.0).items()}
    pos = torch.searchsorted(rows, ids)
    for k, v in leaves_from_rows(D, W, C, D.shape[1]).items():
        prog[k][pos] = v
    d, w, _ = grid_gaps(prog, {k: v[rows] for k, v in ref_leaves.items()}, None)
    return dict(start_d_mm=d * 1e3, start_w=w)


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a missing or non-finite number fails)."""
    return all(np.isfinite(numbers.get(k, np.nan)) and numbers[k] <= limits[k] for k in limits)
