"""Port vs JAX package: the flat bricked layout's "xla" and "rows" merge
tails (``FusionConfig(mode="bricked")``'s default is "xla"), against the JAX
package's tails and against the port's own "pallas" tail (K2's plain version
on the CPU).

Grids within 1e-5 (tests/test_brick_fusion.py's float32 association);
FuseStats counts exactly equal; the frame loop's poses within 1e-5 m.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_brick_fusion import BS, CAM, NB, PARAMS, POSES, Scene, _assert_grids, _frame, _port
from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu.config import FusionConfig
from tracking_sdf_tpu.data.synthetic import look_at, render_scene_depth
from tracking_sdf_tpu.fusion.brick import fuse_frame_bricked as jfuse_bricked
from tracking_sdf_tpu.grid.grid import empty_grid as jempty_grid
from tracking_sdf_tpu.pipeline.runner import Reconstruction as JRecon
from tracking_sdf_tpu_torch import config
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.fusion import brick_merge as tmerge
from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
from tracking_sdf_tpu_torch.grid.grid import FIELDS, empty_grid
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

torch.set_num_threads(2)

FRAMES = [(p, _frame(p, i)) for i, p in enumerate(POSES)]
STATS = ("n_full", "overflow", "n_free", "overflow_active")


def _fuse(merge, cfg, frames, cap=256, cap_free=None, jax_too=True):
    """Fuse the frames with the port's tail ``merge`` (and JAX's): the final
    grids and each frame's stats."""
    gj, gt, stats = jempty_grid(PARAMS), empty_grid(PARAMS, device="cpu"), []
    for pose, (pts, nrm, rgb) in frames:
        rgb_in = rgb if cfg.fuse_color else None
        if jax_too:
            gj, sj = jfuse_bricked(gj, pose, jnp.asarray(pts), jnp.asarray(nrm),
                                   None if rgb_in is None else jnp.asarray(rgb_in),
                                   params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=cap,
                                   merge=merge, cap_free=cap_free)
        gt, st = fuse_frame_bricked(
            gt, _port(pose), torch.from_numpy(pts), torch.from_numpy(nrm),
            None if rgb_in is None else torch.from_numpy(rgb_in), params=PARAMS, cam=CAM,
            cfg=cfg, bs=BS, cap=cap, merge=merge, cap_free=cap_free)
        if jax_too:
            assert tuple(getattr(st, k) for k in STATS) == tuple(int(getattr(sj, k))
                                                                 for k in STATS)
        stats.append(st)
    return gt, gj, stats


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
@pytest.mark.parametrize("merge", ["xla", "rows"])
def test_tail_matches_jax(merge, distance):
    """Three frames with color and the clamp reached."""
    cfg = FusionConfig(mode="bricked", brick_merge=merge, distance=distance, max_weight=2.0)
    before = (tmerge.launches, tmerge.launches_rows)
    gt, gj, stats = _fuse(merge, cfg, FRAMES)
    assert (tmerge.launches, tmerge.launches_rows) == before  # no K2 on these tails
    assert all(s.n_full > 0 and s.n_free > 0 and s.overflow_active == 0 for s in stats)
    _assert_grids(gt, gj)
    assert float(gt.W.max()) == 2.0


@pytest.mark.parametrize("merge", ["xla", "rows"])
def test_tail_matches_pallas_tail(merge):
    """The port's three tails fuse the same grid."""
    cfg = FusionConfig(mode="bricked", pixel_share=4, pixel_share_j=4)
    got, _, _ = _fuse(merge, cfg, FRAMES, jax_too=False)
    ref, _, _ = _fuse("pallas", cfg, FRAMES, jax_too=False)
    for k in FIELDS:
        torch.testing.assert_close(getattr(got, k), getattr(ref, k), atol=1e-5, rtol=0,
                                   msg=k)


def test_rows_free_cap_overflow_matches_jax():
    """A small cap_free drops FREE bricks in the rows tail: reported as
    overflow_active, and the grid is still JAX's."""
    cfg = FusionConfig(mode="bricked", brick_merge="rows", fuse_color=False)
    gt, gj, stats = _fuse("rows", cfg, FRAMES[:2], cap_free=16)
    assert all(s.overflow_active == s.n_free - 16 > 0 for s in stats)
    _assert_grids(gt, gj)


def test_unknown_tail_raises():
    pts, nrm, _ = FRAMES[0][1]
    with pytest.raises(ValueError, match="brick_merge"):
        fuse_frame_bricked(empty_grid(PARAMS, device="cpu"), _port(POSES[0]),
                           torch.from_numpy(pts), torch.from_numpy(nrm), None, params=PARAMS,
                           cam=CAM, cfg=FusionConfig(), bs=BS, merge="scatter")


@pytest.mark.parametrize("merge", ["xla", "rows"])
def test_bricked_reconstruction_matches_jax(merge):
    """``FusionConfig(mode="bricked")`` in the frame loop, with its default
    "xla" tail and with "rows": poses within 1e-5 m, equal stats."""
    cfgs = []
    for pkg in (jconfig, config):
        base = pkg.PipelineConfig()
        fusion = dict(mode="bricked", brick_shape=BS, brick_cap=256)
        if merge != "xla":
            fusion["brick_merge"] = merge
        cfgs.append(dataclasses.replace(base, grid=pkg.GridParams(*PARAMS),
                                        trajectory_path=None, bilateral_mode="separable",
                                        fusion=base.fusion._replace(**fusion)))
    assert cfgs[1].fusion.brick_merge == merge
    cam = PinholeCamera(*CAM)
    j = JRecon(CAM, cfgs[0], initial_pose=POSES[0])
    t = Reconstruction(cam, cfgs[1], initial_pose=_port(POSES[0]), device="cpu")
    for k, eye in enumerate([(0.0, -2.5, 0.25), (0.03, -2.49, 0.26), (0.06, -2.48, 0.24)]):
        depth = np.array(render_scene_depth(Scene(), CAM, look_at(eye, (0.0, 0.0, 0.0))))
        sj = j.process_frame(depth, timestamp=float(k))
        st = t.process_frame(depth, timestamp=float(k))
        assert (st.gn_iterations, st.num_valid) == (sj.gn_iterations, sj.num_valid), k
        np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t), atol=1e-5)
        fj = j.last_fuse_stats
        assert tuple(getattr(t.last_fuse_stats, s) for s in STATS) == tuple(
            int(getattr(fj, s)) for s in STATS), k
    assert t.last_fuse_stats.n_full > 0 and NB > t.last_fuse_stats.n_free > 0
