"""TUM-format trajectories: writing, reading, association, ATE and RPE
(counterpart of tracking_sdf_tpu.pipeline.trajectory).

Lines are ``timestamp tx ty tz qx qy qz qw``. Metrics run in float64 numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.core.lie import Pose, quaternion_from_matrix


@dataclasses.dataclass
class Trajectory:
    """Timestamped camera-to-world poses."""

    timestamps: np.ndarray  # (N,)
    translations: np.ndarray  # (N, 3)
    quaternions: np.ndarray  # (N, 4) (qx, qy, qz, qw)

    def __len__(self) -> int:
        return len(self.timestamps)

    def rotation_matrices(self) -> np.ndarray:
        """(N, 3, 3) float64: metrics must not add float32 rotation noise
        (arccos near 1 amplifies it to ~1e-3 rad)."""
        q = np.asarray(self.quaternions, dtype=np.float64)
        x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        n = (q ** 2).sum(-1)
        s = np.where(n > 0, 2.0 / np.where(n > 0, n, 1.0), 0.0)
        xx, yy, zz = x * x * s, y * y * s, z * z * s
        xy, xz, yz = x * y * s, x * z * s, y * z * s
        wx, wy, wz = w * x * s, w * y * s, w * z * s
        return np.stack([
            np.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
            np.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
            np.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
        ], axis=-2)


def _line(timestamp: float, t: np.ndarray, q: np.ndarray) -> str:
    """A pose's TUM line from its float64 translation and quaternion."""
    return (f"{timestamp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


class TrajectoryWriter:
    """Streaming TUM-format writer; the file opens on the first write."""

    def __init__(self, path: str, append: bool = False):
        self._path = path
        self._append = append
        self._f = None

    @property
    def started(self) -> bool:
        return self._f is not None

    def set_append(self, append: bool) -> None:
        """Switch to append mode, before the first write only (a restored
        run keeps the poses written before it stopped)."""
        if self._f is not None:
            raise RuntimeError("set_append after the first write")
        self._append = append

    def _open(self):
        if self._f is None:
            self._f = open(self._path, "a" if self._append else "w")
        return self._f

    def write(self, timestamp: float, pose: Pose) -> None:
        """One pose's line, flushed."""
        f = self._open()
        t = pose.t.detach().cpu().numpy().astype(np.float64)
        q = quaternion_from_matrix(pose.R).detach().cpu().numpy().astype(np.float64)
        f.write(_line(timestamp, t, q))
        f.flush()

    def write_chunk(self, timestamps: Sequence[float], R: torch.Tensor, t: torch.Tensor,
                    keep) -> int:
        """The lines of the poses ``R`` (n, 3, 3) and ``t`` (n, 3) whose
        ``keep`` (n booleans) is set, written and flushed at once; returns
        how many. One quaternion_from_matrix over the n rotations gives each
        the bits that ``write`` gives it alone, so the bytes are those of
        ``write`` on each kept pose in turn. With none kept, no file opens."""
        keep = np.asarray(keep, dtype=bool)
        rows = np.flatnonzero(keep)
        if rows.size == 0:
            return 0
        tt = t.detach().cpu().numpy().astype(np.float64)
        q = quaternion_from_matrix(R).detach().cpu().numpy().astype(np.float64)
        f = self._open()
        f.write("".join(_line(float(timestamps[i]), tt[i], q[i]) for i in rows))
        f.flush()
        return int(rows.size)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory(path: str) -> Trajectory:
    """Read a TUM trajectory/groundtruth file ('#' headers skipped)."""
    ts, tr, qu = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 8:
                continue
            ts.append(vals[0])
            tr.append(vals[1:4])
            qu.append(vals[4:8])
    return Trajectory(np.asarray(ts), np.asarray(tr), np.asarray(qu))


def associate(a_stamps: np.ndarray, b_stamps: np.ndarray,
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp matching (the TUM associate.py rule)."""
    pairs = []
    used = set()
    for i, ta in enumerate(a_stamps):
        j = int(np.searchsorted(b_stamps, ta))
        best, best_dt = None, max_dt
        for jj in (j - 1, j, j + 1):
            if 0 <= jj < len(b_stamps) and jj not in used:
                dt = abs(b_stamps[jj] - ta)
                if dt <= best_dt:
                    best, best_dt = jj, dt
        if best is not None:
            pairs.append((i, best))
            used.add(best)
    return pairs


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity (s, R, t) with dst ≈ s * R @ src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    C = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(C)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / ((xs ** 2).sum() / len(src))) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(estimated: Trajectory, groundtruth: Trajectory,
             max_dt: float = 0.02, align: bool = True) -> Tuple[float, int]:
    """Absolute trajectory error RMSE (m) after SE(3) alignment; (rmse, pairs)."""
    pairs = associate(estimated.timestamps, groundtruth.timestamps, max_dt)
    if len(pairs) < 2:
        return float("nan"), len(pairs)
    src = estimated.translations[[p[0] for p in pairs]]
    dst = groundtruth.translations[[p[1] for p in pairs]]
    if align:
        s, R, t = align_umeyama(src, dst)
        src = (s * (R @ src.T)).T + t
    err = np.linalg.norm(src - dst, axis=1)
    return float(np.sqrt((err ** 2).mean())), len(pairs)


def rpe_rmse(estimated: Trajectory, groundtruth: Trajectory, delta: int = 1,
             max_dt: float = 0.02) -> Tuple[float, float]:
    """Relative pose error over ``delta``-frame intervals: (translational
    RMSE in m, rotational RMSE in rad); NaN with fewer than delta + 1 pairs."""
    pairs = associate(estimated.timestamps, groundtruth.timestamps, max_dt)
    if len(pairs) < delta + 1:
        return float("nan"), float("nan")
    Re, Rg = estimated.rotation_matrices(), groundtruth.rotation_matrices()
    te, tg = estimated.translations, groundtruth.translations

    def rel(R, t, i0, i1):
        return R[i0].T @ R[i1], R[i0].T @ (t[i1] - t[i0])

    t_errs, r_errs = [], []
    for k in range(len(pairs) - delta):
        (i0, j0), (i1, j1) = pairs[k], pairs[k + delta]
        Rei, tei = rel(Re, te, i0, i1)
        Rgi, tgi = rel(Rg, tg, j0, j1)
        Rd, td = Rei.T @ Rgi, Rei.T @ (tgi - tei)
        t_errs.append(np.linalg.norm(td))
        r_errs.append(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1.0, 1.0)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
