"""The raycaster's leaps: ``RaycastConfig(empty_skip=True)`` and
``far_field="chamfer"``, against the port's plain march and the JAX
package.

Grid: a dense fusion of one frame at m=64 (observed and unobserved space,
a truncated field), seen from another pose, and the JAX suite's analytic
sphere + box (observed everywhere).
  * The leap mips (chamfer distances to observed / surface-band 8^3 bricks)
    equal the JAX package's.
  * empty_skip leaps only through unobserved space, where no crossing is:
    hits, depths and normals equal to the plain march's, and no ray takes
    more steps. It also renders as the JAX package's empty_skip does.
  * far_field="chamfer" leaps anywhere far from the surface band, one voxel
    cell's diagonal short of the JAX package's leap (its fault R3: the leap
    may otherwise overshoot a crossing that lies just beyond its band brick).
    A leap changes where a ray freezes before the Newton finish, so a
    grazing ray may end on the other side of a threshold, and on a fused
    (projective, truncated) field, where the plain march itself can step
    past a crossing, a ray may freeze on the far side of it: hit masks
    differ on at most 1% of the pixels, on the analytic field only on
    silhouettes (a 3x3 neighbourhood of the plain render with hits and
    misses); depth on common hits within hit_epsilon (1e-3 m, where either
    march may stop) on the analytic field, and within 1e-4 m on >= 98% of
    them on the fused one (the rest found another crossing); fewer steps on
    average. The JAX package's own leap loses hits on this fused grid too.
  * The band leap is sound: every leap taken before a ray first enters a
    surface-band brick lands at least one cell diagonal before that entry,
    which the JAX package's longer leap does not (R3). The hits a leap
    render loses or gains come from the ordinary steps that follow a leap.
  * Outside the JAX package's conditions (m a multiple of 8 with (m/8)^3 a
    multiple of 128; the band only in the nearest march) nothing leaps:
    the render equals the plain one, steps included.
"""
import functools
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import GridParams as JGridParams
from tracking_sdf_tpu.config import RaycastConfig as JRaycastConfig
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose as JPose
from tracking_sdf_tpu.data import CuboidScene as JCuboid
from tracking_sdf_tpu.data import SphereScene as JSphere
from tracking_sdf_tpu.data import grid_from_scene as jgrid_from_scene
from tracking_sdf_tpu.grid.grid import TSDFGrid as JTSDFGrid
from tracking_sdf_tpu.grid.interp import masked_view as jmasked_view
from tracking_sdf_tpu_torch.config import GridParams, PipelineConfig, RaycastConfig
from tracking_sdf_tpu_torch.core.camera import pixel_rays
from tracking_sdf_tpu_torch.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu_torch.grid.grid import FIELDS, grid_from_numpy, world_to_voxel
from tracking_sdf_tpu_torch.grid.interp import masked_view
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

jraycast = importlib.import_module("tracking_sdf_tpu.render.raycast")
# the module: the package attribute of this name is the function
traycast = importlib.import_module("tracking_sdf_tpu_torch.render.raycast")
torch.set_num_threads(2)

KW = dict(m=64, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0), delta=0.1,
          epsilon=0.01)
PARAMS, JPARAMS = GridParams(**KW), JGridParams(**KW)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
BASE = RaycastConfig(t_near=0.05, t_far=4.0)
# a budget that no ray of the plain march exhausts, and no compacted
# recovery phase: a ray's outcome then depends on its path alone, not on
# the steps or slots a leap saves it
ROOMY = dict(max_steps=512, two_phase="off")
VIEWS = [(0.3, -1.6, 0.3), (-0.5, -1.4, 0.5)]


class _Union:
    def __init__(self, *parts):
        self.parts = parts

    def intersect(self, o, d):
        t = self.parts[0].intersect(o, d)
        for s in self.parts[1:]:
            tb = s.intersect(o, d)
            t = torch.where(torch.isnan(t), tb, torch.where(torch.isnan(tb), t,
                                                             torch.minimum(t, tb)))
        return t


@functools.lru_cache(maxsize=None)
def fused():
    """One frame of the sphere + box fused densely at m=64 (the port)."""
    scene = _Union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                   CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    pose = look_at((0.0, -1.5, 0.2), (0.0, 0.0, 0.0), device="cpu")
    r = Reconstruction(CAM, PipelineConfig(grid=PARAMS, trajectory_path=None), device="cpu",
                       initial_pose=pose)
    r.process_frame(render_scene_depth(scene, CAM, pose))
    return r.grid


@functools.lru_cache(maxsize=None)
def analytic():
    jg = jgrid_from_scene(JPARAMS, _JUnion())
    return jg, grid_from_numpy(jg._asdict(), device="cpu")


class _JUnion:
    parts = (JSphere(center=(0.15, 0.1, 0.0), radius=0.4),
             JCuboid(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))

    def sdf(self, x):
        return jnp.minimum(self.parts[0].sdf(x), self.parts[1].sdf(x))

    def color(self, x):
        return self.parts[0].color(x)


def _render(grid, eye, **kw):
    pose = look_at(eye, (0.0, 0.0, 0.0), device="cpu")
    return traycast.raycast(grid, pose, params=PARAMS, cam=CAM, cfg=BASE._replace(**kw))


def test_leap_mips_match_jax():
    g = fused()
    W, D = g.W.numpy(), g.D.numpy()
    assert 0.02 < (W > 0).mean() < 0.95
    np.testing.assert_array_equal(traycast._skip_mip(g.W).numpy(),
                                  np.asarray(jraycast._skip_mip(jnp.asarray(W))))
    Dm = masked_view(g.D, g.W)
    jDm = jmasked_view(jnp.asarray(D), jnp.asarray(W))
    for band in (0.75, 0.3):
        np.testing.assert_array_equal(traycast._band_skip_mip(Dm, PARAMS, band).numpy(),
                                      np.asarray(jraycast._band_skip_mip(jDm, JPARAMS, band)))
    occ = np.random.default_rng(0).random((16, 16, 16)) < 0.01
    got = traycast._chamfer(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jraycast._chamfer(jnp.asarray(occ))))
    assert got.max() > 1 and got.min() == 0


@pytest.mark.parametrize("sample", ["nearest_far", "trilinear"])
@pytest.mark.parametrize("eye", VIEWS, ids=["view0", "view1"])
def test_empty_skip_equals_plain_march(eye, sample):
    g = fused()
    a = _render(g, eye, sample=sample, **ROOMY)
    b = _render(g, eye, sample=sample, empty_skip=True, **ROOMY)
    assert torch.equal(a.hit, b.hit) and int(a.hit.sum()) > 300
    both = a.hit
    assert float((a.depth - b.depth).abs()[both].max()) <= 1e-6
    assert float((a.normal_world - b.normal_world).abs()[both].max()) <= 1e-5
    assert bool((b.steps <= a.steps).all()) and b.steps.sum() < 0.9 * a.steps.sum()


def test_empty_skip_matches_jax():
    g = fused()
    jg = JTSDFGrid(**{k: jnp.asarray(getattr(g, k).numpy()) for k in FIELDS})
    pose = look_at(VIEWS[0], (0.0, 0.0, 0.0), device="cpu")
    want = jraycast.raycast(jg, JPose(jnp.asarray(pose.R.numpy()), jnp.asarray(pose.t.numpy())),
                            params=JPARAMS, cam=CAM,
                            cfg=JRaycastConfig(t_near=0.05, t_far=4.0, empty_skip=True))
    got = traycast.raycast(g, pose, params=PARAMS, cam=CAM,
                           cfg=BASE._replace(empty_skip=True))
    ha = np.asarray(want.hit)
    assert (got.hit.numpy() == ha).mean() >= 0.999
    both = ha & got.hit.numpy()
    err = np.abs(got.depth.numpy() - np.asarray(want.depth))[both]
    assert (err <= 1e-4).mean() >= 0.995 and err.max() <= 2e-3
    assert (got.steps.numpy() == np.asarray(want.steps)).mean() >= 0.99


def _silhouette(hit: torch.Tensor) -> torch.Tensor:
    """Pixels whose 3x3 neighbourhood holds both hits and misses."""
    h = torch.nn.functional.pad(hit.float()[None, None], (1, 1, 1, 1), mode="replicate")
    hi = torch.nn.functional.max_pool2d(h, 3, 1)[0, 0]
    lo = -torch.nn.functional.max_pool2d(-h, 3, 1)[0, 0]
    return hi != lo


@pytest.mark.parametrize("grid", ["fused", "analytic"])
@pytest.mark.parametrize("eye", VIEWS, ids=["view0", "view1"])
def test_far_field_chamfer_agrees_with_plain_march(eye, grid):
    g = fused() if grid == "fused" else analytic()[1]
    a = _render(g, eye)
    b = _render(g, eye, far_field="chamfer")
    c = _render(g, eye, far_field="chamfer", empty_skip=True)  # both leaps
    for r in (b, c):
        differ = a.hit != r.hit
        assert int(a.hit.sum()) > 300 and differ.float().mean() <= 0.01
        err = (a.depth - r.depth).abs()[a.hit & r.hit]
        if grid == "analytic":  # a Euclidean field: grazing rays only
            assert not bool((differ & ~_silhouette(a.hit)).any())
            assert float(err.max()) <= BASE.hit_epsilon
        else:
            assert (err <= 1e-4).float().mean() >= 0.98
    assert b.steps.float().mean() < 0.9 * a.steps.float().mean()
    assert c.steps.float().mean() <= b.steps.float().mean()


def _first_band_entry_t(band, o, u, h):
    """Per ray o + t u (t in [t_near, t_far], sampled every h / 20): the first
    t inside a surface-band brick of the leap mip ``band`` (its chamfer
    distance 0, in the leap's own brick addressing); inf where there is
    none. A sampled entry can only come later than the true one."""
    ts = torch.arange(BASE.t_near, BASE.t_far, h / 20)
    nb = band.shape[0]
    first = torch.full((u.shape[0],), float("inf"))
    for c in torch.split(ts, 512):
        uvw = world_to_voxel(PARAMS, o + c[None, :, None] * u[:, None, :])
        inside = ((uvw >= 0) & (uvw < PARAMS.m)).all(-1)
        b = (uvw / 8).to(torch.int64).clamp(0, nb - 1)
        hit = inside & (band[b[..., 0], b[..., 1], b[..., 2]] == 0)
        first = torch.minimum(first, torch.where(hit.any(1), c[hit.to(torch.int8).argmax(1)],
                                                 float("inf")))
    return first


@pytest.mark.parametrize("grid", ["fused", "analytic"])
@pytest.mark.parametrize("eye", VIEWS, ids=["view0", "view1"])
def test_band_leap_lands_a_cell_diagonal_short_of_the_band(eye, grid, monkeypatch):
    """far_field="chamfer" is sound: every band leap taken before a ray first
    enters a surface-band brick lands at least one voxel cell's diagonal
    before that entry (fault R3 fixed). The nearest march freezes only on a
    voxel below fine_threshold voxels < far_band·delta, which lies in a band
    brick, so no leap carries a ray past where the plain march stops. (The
    hits that the leap render loses or gains come from the march's ordinary
    steps, which start from other points after a leap: on a projective fused
    field they can step past a thin freeze region, in either render, and a
    ray that freezes elsewhere in the same region may finish on another
    crossing. The JAX package's leap loses hits on this fused grid too.)"""
    g = fused() if grid == "fused" else analytic()[1]
    h = PARAMS.width / PARAMS.m
    assert BASE.fine_threshold * h < BASE.far_band * PARAMS.delta
    samples, real = [], traycast._leap  # each nearest step's sample points
    monkeypatch.setattr(traycast, "_leap",
                        lambda mip, uvw, ext: samples.append(uvw) or real(mip, uvw, ext))
    _render(g, eye, far_field="chamfer")
    pose = look_at(eye, (0.0, 0.0, 0.0), device="cpu")
    d = traycast._rotate(pose.R, pixel_rays(CAM, 1, device="cpu")[0]).reshape(-1, 3)
    u = d / d.norm(dim=-1, keepdim=True)
    band = traycast._band_skip_mip(masked_view(g.D, g.W), PARAMS, BASE.far_band)
    entry = _first_band_entry_t(band, pose.t, u, h)
    scale = torch.tensor([PARAMS.m / s for s in PARAMS.extent])
    ts = [(((uvw + 0.5) / scale + torch.tensor(PARAMS.origin) - pose.t) * u).sum(-1)
          for uvw in samples]
    cell_diag = math.sqrt(sum(v * v for v in PARAMS.voxel_size))
    n_taken, margin = 0, float("inf")
    Dm = masked_view(g.D, g.W)
    for uvw, t, t_next in zip(samples, ts, ts[1:]):
        # a step longer than the nearest voxel's ordinary step is a leap
        n = torch.round(uvw).clamp(0, PARAMS.m - 1).to(torch.int64)
        phi = Dm[n[:, 0], n[:, 1], n[:, 2]]
        ordinary = torch.where(torch.isfinite(phi), (phi - traycast._LIPSCHITZ_MARGIN * h)
                               .clamp(min=0.0) * BASE.step_scale, PARAMS.delta / 2)
        taken = (t < entry) & (t_next - t > ordinary.clamp(max=PARAMS.delta) + 1e-5)
        n_taken += int(taken.sum())
        if taken.any():
            margin = min(margin, float((entry - cell_diag - t_next)[taken].min()))
    assert n_taken > 1000 and margin >= -1e-5, (n_taken, margin)


def test_no_leap_outside_the_jax_conditions():
    """m=48: (48/8)^3 = 216 is no multiple of 128, so neither mip is built;
    and the band leaps only in the nearest march."""
    g = fused()
    small = GridParams(**dict(KW, m=48))
    g48 = grid_from_numpy({k: getattr(g, k)[:48, :48, :48].numpy() for k in FIELDS},
                          device="cpu")
    pose = look_at(VIEWS[0], (0.0, 0.0, 0.0), device="cpu")
    cases = ((g48, small, BASE, dict(empty_skip=True, far_field="chamfer")),
             (g, PARAMS, BASE._replace(sample="trilinear"), dict(far_field="chamfer")))
    for grid, params, base, kw in cases:
        a = traycast.raycast(grid, pose, params=params, cam=CAM, cfg=base)
        b = traycast.raycast(grid, pose, params=params, cam=CAM, cfg=base._replace(**kw))
        assert int(a.hit.sum()) > 100
        for name in ("hit", "steps", "depth"):
            assert torch.equal(torch.nan_to_num(getattr(a, name)),
                               torch.nan_to_num(getattr(b, name))), name
