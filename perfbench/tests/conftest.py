"""The benchmark's CPU tests (``python -m pytest perfbench/tests``): the
harness's packages (perfbench/harness, perfbench/reference) and the port on
the path, and a small cell for runs on the CPU."""
from __future__ import annotations

import copy
import os
import sys

import pytest

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [PERFBENCH, os.path.dirname(PERFBENCH)]


def small_cell(config: str = "tum256", traffic: str = "handheld"):
    """(configuration, traffic, limits) of a cell cut to run on the CPU in
    seconds: a 64^3 grid, 80x60 frames, 20 frames in chunks of 4, sessions
    of 12 frames. The limits are the cell's own."""
    from harness import data

    cfg = copy.deepcopy(data.load_json(data.PERFBENCH / "configs" / f"{config}.json"))
    cfg["grid"]["m"] = 64
    cfg["camera"] = dict(fx=517.3 / 8, fy=516.5 / 8, cx=318.6 / 8, cy=255.3 / 8, width=80,
                         height=60)
    tr = copy.deepcopy(data.load_json(data.PERFBENCH / "traffic" / f"{traffic}.json"))
    tr["frames"], tr["chunk"], tr["session_frames"] = 20, 4, 12
    limits = data.load_json(data.PERFBENCH / "limits" / f"{config}.{traffic}.json")
    return cfg, tr, limits


@pytest.fixture
def small(monkeypatch):
    """The small cell, with the program's plain Gauss-Newton step on the
    CPU doing the card's arithmetic: the queries' terms added in K1's
    launch order (the port's own ``sums_in_launch_order`` over its
    ``query_terms_reference``) and the finish's float64 solve and float32
    update as ``gn_step`` does them on the card, which the reference
    follows. On the CPU the program otherwise adds in torch's order and
    solves in float32, and on the small cell's coarse grid right after the
    bootstrap frame that parts the poses by up to a millimetre within a few
    frames."""
    import numpy as np
    import torch

    from reference import track as rt
    from tracking_sdf_tpu_torch.tracking import gn_reduce as g

    def in_launch_order(Dm, pose, points, params, i0=0, slab=None):
        return g.sums_in_launch_order(
            g.query_terms_reference(Dm, pose, points, params, i0=i0, slab=slab))

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
    monkeypatch.setattr(g, "gn_reduce_reference", in_launch_order)
    monkeypatch.setattr(g, "advance_state", card_finish)
    return small_cell()
