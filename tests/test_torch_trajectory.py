"""TrajectoryWriter.write_chunk, the chunk path's one batched write, against
the per-frame write on the same poses: the same bytes, line for line, on
random rotations, the identity, the half turns about each axis (the ties of
Shepperd's argmax), rejected frames anywhere in a chunk, a chunk with no
kept frame, and append mode. The poses come as the chunk's records hold
them: float32 views into one (n, 23) row block."""
import numpy as np
import pytest
import torch

from tracking_sdf_tpu_torch.core.lie import Pose, matrix_from_quaternion
from tracking_sdf_tpu_torch.pipeline import chunk as chunked
from tracking_sdf_tpu_torch.pipeline.trajectory import TrajectoryWriter, read_trajectory

N = 8
HALF_TURNS = [np.diag(d).astype(np.float32) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]


def random_rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return matrix_from_quaternion(torch.from_numpy(q)).numpy().astype(np.float32)


def records(rotations, rng):
    """(n, REC) float32 rows with the rotations and random translations in
    their slots, as the chunk step's read leaves them."""
    n = len(rotations)
    out = torch.from_numpy(rng.standard_normal((n, chunked.REC)).astype(np.float32))
    out[:, chunked.REC_R:chunked.REC_T] = torch.from_numpy(np.reshape(rotations, (n, 9)))
    return out


def case_rotations(name, rng):
    if name == "identity":
        return np.broadcast_to(np.eye(3, dtype=np.float32), (N, 3, 3)).copy()
    if name == "half_turns":
        return np.stack([HALF_TURNS[i % 3] for i in range(N)])
    return random_rotations(rng, N)


CASES = {  # rotations, the rejected frames, append after a header line
    "random": ("random", [], False),
    "identity": ("identity", [], False),
    "half_turns": ("half_turns", [], False),
    "rejected_first": ("random", [0], False),
    "rejected_middle": ("random", [3], False),
    "rejected_last": ("random", [N - 1], False),
    "all_rejected": ("random", list(range(N)), False),
    "append": ("random", [2], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_write_chunk_is_the_per_frame_writes_byte_for_byte(tmp_path, case):
    kind, rejected, append = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    out = records(case_rotations(kind, rng), rng)
    keep = np.ones(N, dtype=bool)
    keep[rejected] = False
    stamps = list(1305031102.175304 + 0.033 * np.arange(N))
    R = out[:, chunked.REC_R:chunked.REC_T].reshape(N, 3, 3)
    t = out[:, chunked.REC_T:chunked.REC_ITERS]
    paths = [tmp_path / "frames.txt", tmp_path / "chunk.txt"]
    writers = [TrajectoryWriter(str(p)) for p in paths]
    if append:
        for p, w in zip(paths, writers):
            p.write_text("# timestamp tx ty tz qx qy qz qw\n")
            w.set_append(True)
    for i in np.flatnonzero(keep):
        writers[0].write(stamps[i], Pose(R[i], t[i]))
    written = writers[1].write_chunk(stamps, R, t, keep)
    assert written == int(keep.sum())
    assert writers[1].started == bool(keep.any())
    if not keep.any():  # nothing kept, nothing opened
        assert not paths[1].exists() and not paths[0].exists()
        return
    # flushed before the call returns: a reader sees every line, writer open
    seen = paths[1].read_bytes()
    for w in writers:
        w.close()
    assert seen == paths[0].read_bytes() == paths[1].read_bytes()
    lines = seen.decode().splitlines()
    assert len(lines) == written + append
    if append:
        assert lines[0].startswith("#")
    traj = read_trajectory(str(paths[1]))
    assert traj.timestamps.tolist() == [float(f"{s:.6f}") for s, k in zip(stamps, keep) if k]
