"""The generator: seeds, traversal and the motion the traffic files state."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from harness import data, traffic as gen

CAM = dict(fx=517.3 / 8, fy=516.5 / 8, cx=318.6 / 8, cy=255.3 / 8, width=80, height=60)


def _traffic(name="handheld", frames=12):
    tr = data.load_json(data.PERFBENCH / "traffic" / f"{name}.json")
    tr["frames"] = frames
    return tr


def test_same_seed_same_frames_other_seed_other_noise():
    tr = _traffic()
    a = gen.generate(tr, CAM, 2 ** 31 + 5, "cpu", 4)
    b = gen.generate(tr, CAM, 2 ** 31 + 5, "cpu", 4)
    c = gen.generate(tr, CAM, 2 ** 31 + 6, "cpu", 4)
    assert torch.equal(a.depth, b.depth) and torch.equal(a.rgb, b.rgb)
    assert not torch.equal(a.depth, c.depth)
    assert torch.equal(a.rgb, c.rgb)  # color carries no noise
    assert a.depth.dtype == torch.int16 and a.rgb.dtype == torch.uint8


@pytest.mark.parametrize("n,length", [(5, 20), (600, 1206), (2, 6)])
def test_pingpong_traversal(n, length):
    order = gen.traversal(n, length)
    want, f, step = [], 0, 1
    for _ in range(length):
        want.append(f)
        if not 0 <= f + step < n:
            step = -step
        f += step
    assert order.tolist() == want


def test_chunks_are_contiguous_slices_in_traversal_order():
    seq = gen.generate(_traffic(frames=5), CAM, 1, "cpu", 4)
    assert seq.period == 8 and seq.depth.shape[0] == 12
    first = {}  # the staged image of each frame index
    for p, f in enumerate(seq.frame):
        first.setdefault(int(f), seq.depth[p])
        assert torch.equal(seq.depth[p], first[int(f)])
    order = gen.traversal(5, 40)
    for j in range(0, 30, 3):
        d, c = seq.chunk(j, 4)
        assert d.is_contiguous() and d.shape[0] == 4 and c.shape[0] == 4
        for k in range(4):
            assert torch.equal(d[k], first[int(order[j + k])])


@pytest.mark.parametrize("name", ["handheld", "slow"])
def test_motion_per_frame_matches_the_traffic_file(name):
    tr = _traffic(name, frames=600)
    poses = gen.camera_path(tr)
    dt, ang = [], []
    for a, b in zip(poses[:-1], poses[1:]):
        Ra, Rb = a.R.double().numpy(), b.R.double().numpy()
        dt.append(np.linalg.norm(Ra.T @ (b.t.double().numpy() - a.t.double().numpy())) * 1e3)
        chord = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))  # = sin(angle / 2)
        ang.append(np.degrees(2.0 * np.arcsin(chord)))
    dt, ang = np.mean(dt), np.mean(ang)
    m = tr["motion"]
    assert dt == pytest.approx(m["mean_translation_mm"], rel=1e-3)
    assert ang == pytest.approx(m["mean_rotation_deg"], rel=1e-2)


def test_the_camera_sees_the_scene_and_stays_in_the_grid():
    tr = _traffic(frames=600)
    for p in gen.camera_path(tr):
        assert (p.t.abs() < 2.5).all()
    seq = gen.generate(dict(tr, frames=60), CAM, 3, "cpu", 4)
    valid = ((seq.depth.to(torch.int32) & 0xFFFF) > 0).float().mean((1, 2))
    assert float(valid.min()) > 0.9
    assert math.isclose(gen.DEPTH_SCALE, 5000.0)
