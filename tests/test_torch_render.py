"""The port's interpolants, analytic grids and raycaster against the JAX
package's, on the CPU.

Inputs: numpy arrays from a seed, the JAX suite's own sphere grid
(``grid_from_scene`` on GridParams(m=64) over a 2 m cube, delta 0.1, seen by
a 96x72 camera, tests/test_render.py) and one fused grid: the dense view of
the port's tum256 loop at m=48 (bf16 brick-major rows) after three frames of
test_torch_slice.py's scene, which holds unobserved voxels and a truncated
field. Both packages get the same float32 arrays.

Tolerances:
  * interpolants: 1e-6 absolute plus 4e-6 of the largest entry of the
    query's row (the same float32 formulas, summed over the 8 corners in
    another order: a few ulps; a query 3e-6 voxels from an unobserved
    corner has gradients of ~1e5), valid masks equal; autograd of the
    interpolant the same with 1e-5 absolute; grid_from_scene 1e-6;
  * raycast: hit masks equal on >= 99.9% of the pixels; on common hits
    depth and range_t within 1e-4 m, normals within 1e-4 and rgb within
    1e-5 on >= 99.5% of them (the rest are grazing rays whose march takes
    one step more or less where a float32 sum in another order crosses a
    threshold; every one of them within 2e-3 m, and their normals within
    1e-2), steps equal on >= 99%, dropped equal;
  * gradients (autograd against jax.grad): rtol 1e-3, with an absolute
    floor of 1e-3 times the largest entry for the per-voxel D gradient.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import BOX, CAM as CAM48, PARAMS as PARAMS48, SPHERE, WALL, Scene, _orbit
from tracking_sdf_tpu.config import GridParams as JGridParams
from tracking_sdf_tpu.config import RaycastConfig as JRaycastConfig
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose as JPose
from tracking_sdf_tpu.data import CuboidScene as JCuboid
from tracking_sdf_tpu.data import SphereScene as JSphere
from tracking_sdf_tpu.data import grid_from_scene as jgrid_from_scene
from tracking_sdf_tpu.data import look_at as jlook_at
from tracking_sdf_tpu.data import render_scene_depth as jrender_scene_depth
from tracking_sdf_tpu.grid import interp as jinterp
from tracking_sdf_tpu.grid.grid import TSDFGrid as JTSDFGrid
from tracking_sdf_tpu.render import raycast as jraycast
from tracking_sdf_tpu.render.image_io import render_panels as jrender_panels
from tracking_sdf_tpu_torch.config import GridParams, RaycastConfig, preset
from tracking_sdf_tpu_torch.core.lie import Pose, pose_from_numpy
from tracking_sdf_tpu_torch.data import synthetic
from tracking_sdf_tpu_torch.data.tum import decode_png
from tracking_sdf_tpu_torch.grid import interp
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid, grid_from_numpy
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.render.image_io import render_panels, save_render_png
from tracking_sdf_tpu_torch.render.raycast import raycast

torch.set_num_threads(2)

KW = dict(m=64, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0), delta=0.1,
          epsilon=0.01)
PARAMS, JPARAMS = GridParams(**KW), JGridParams(**KW)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
JPOSE = jlook_at((0.0, -1.6, 0.2), (0.0, 0.0, 0.0))
POSE = pose_from_numpy(JPOSE.R, JPOSE.t, device="cpu")
HIT_AGREE, VALUE_SHARE, STEPS_AGREE = 0.999, 0.995, 0.99
TOL_DEPTH, TOL_NORMAL, TOL_RGB = 1e-4, 1e-4, 1e-5
TOL_DEPTH_ALL, TOL_NORMAL_ALL = 2e-3, 1e-2


@functools.lru_cache(maxsize=None)
def sphere_grids():
    """(JAX grid, port grid): the JAX suite's sphere, the same arrays."""
    jg = jgrid_from_scene(JPARAMS, JSphere(center=(0.0, 0.0, 0.0), radius=0.5))
    return jg, grid_from_numpy(jg._asdict(), device="cpu")


@functools.lru_cache(maxsize=None)
def fused_grids():
    """(JAX grid, port grid, params, JAX params, camera, JAX pose): the
    dense view of the port's tum256 loop at m=48 (bf16 rows) after three
    frames, and the first frame's pose."""
    cfg = preset("tum256")
    nb = (PARAMS48.m // 8) ** 3
    cfg = dataclasses.replace(cfg, grid=GridParams(**PARAMS48._asdict()), trajectory_path=None,
                              fusion=cfg.fusion._replace(brick_cap=nb, brick_cap_free=nb))
    poses = _orbit(3, dist=2.45)
    r = Reconstruction(CAM48, cfg, device="cpu",
                       initial_pose=pose_from_numpy(poses[0].R, poses[0].t, device="cpu"))
    rgb = np.broadcast_to(np.asarray([0.7, 0.4, 0.2], np.float32), (72, 96, 3))
    for i, p in enumerate(poses):
        r.process_frame(np.array(jrender_scene_depth(Scene((SPHERE, BOX, WALL)), CAM48, p)),
                        rgb=rgb, timestamp=float(i))
    assert r._bgrid.D.dtype == torch.bfloat16 and not any(s.rejected for s in r.stats)
    g = r.grid
    arrays = {k: getattr(g, k).numpy() for k in FIELDS}
    assert 0.05 < (arrays["W"] > 0).mean() < 0.95  # unobserved space is there
    return (JTSDFGrid(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            grid_from_numpy(arrays, device="cpu"), cfg.grid, PARAMS48, CAM48, poses[0])


# --- interpolants --------------------------------------------------------------

def _assert_rows_close(got, want, atol, rtol=4e-6):
    """|got - want| <= atol + rtol * (the largest |want| of the row)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(want.shape[0], -1).max(-1)
    err = np.abs(got - want).reshape(want.shape[0], -1).max(-1)
    assert (err <= atol + rtol * scale).all(), (err.max(), np.argmax(err - rtol * scale))


def _interp_inputs():
    rng = np.random.default_rng(7)
    m = 12
    vols = [rng.normal(size=(m, m, m)).astype(np.float32) for _ in range(3)]
    W = ((rng.uniform(size=(m, m, m)) > 0.3) * rng.uniform(1.0, 5.0, size=(m, m, m))
         ).astype(np.float32)
    coords = np.concatenate([
        rng.uniform(-1.5, m + 0.5, size=(400, 3)),  # out of bounds and negative
        rng.integers(0, m, size=(40, 3)).astype(np.float64),  # exact corners
        rng.integers(0, m, size=(40, 3)) + np.array([3e-6, 0.0, 0.0]),
    ]).astype(np.float32)
    return vols, W, coords


INTERPOLANTS = {
    "trilinear_with_grad": lambda f, v, W, c: f.trilinear_with_grad(v[0], W, c),
    "trilinear": lambda f, v, W, c: f.trilinear(v[0], W, c),
    "shepard_l1": lambda f, v, W, c: f.shepard_l1(v[0], W, c),
    "shepard_color": lambda f, v, W, c: f.shepard_color(v[0], v[1], v[2], W, c),
    "interp_color": lambda f, v, W, c: f.interp_color(v[0], v[1], v[2], W, c),
}


@pytest.mark.parametrize("name", sorted(INTERPOLANTS))
def test_interpolant_matches_jax(name):
    """Random coordinates (out of bounds, negative and on corners included)
    over a grid with 30% of the voxels unobserved."""
    vols, W, coords = _interp_inputs()
    fn = INTERPOLANTS[name]
    want = fn(jinterp, [jnp.asarray(v) for v in vols], jnp.asarray(W), jnp.asarray(coords))
    got = fn(interp, [torch.from_numpy(v) for v in vols], torch.from_numpy(W),
             torch.from_numpy(coords))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
            assert 0 < w.mean() < 1
        else:
            _assert_rows_close(g.numpy(), w, atol=1e-6)


def test_trilinear_with_grad_autograd_matches_jax():
    """Autograd of sum(value) w.r.t. the coordinates and D against jax.grad,
    and the analytic gradient against autograd's."""
    vols, W, coords = _interp_inputs()

    def jf(D, c):
        return jnp.sum(jinterp.trilinear_with_grad(D, jnp.asarray(W), c)[0])

    jgD, jgc = jax.grad(jf, argnums=(0, 1))(jnp.asarray(vols[0]), jnp.asarray(coords))
    D = torch.from_numpy(vols[0]).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    value, grad, valid = interp.trilinear_with_grad(D, torch.from_numpy(W), c)
    value.sum().backward()
    _assert_rows_close(D.grad.numpy().reshape(-1, 1), np.asarray(jgD).reshape(-1, 1), atol=1e-5)
    _assert_rows_close(c.grad.numpy(), jgc, atol=1e-5)
    _assert_rows_close(c.grad.numpy()[valid.numpy()], grad.detach().numpy()[valid.numpy()],
                       atol=1e-5)


@pytest.mark.parametrize("scene", ["sphere", "box", "box_reference_style"])
def test_grid_from_scene_matches_jax(scene):
    p = dict(KW, m=24, origin=(-1.1, -0.9, -1.0))
    if scene == "sphere":
        pair = (JSphere(center=(0.1, -0.2, 0.05), radius=0.6),
                synthetic.SphereScene(center=(0.1, -0.2, 0.05), radius=0.6))
    else:
        box = dict(min_corner=(-0.5, -0.3, -0.6), max_corner=(0.4, 0.5, 0.2))
        pair = (JCuboid(**box), synthetic.CuboidScene(**box))
    ref = scene == "box_reference_style"
    want = jgrid_from_scene(JGridParams(**p), pair[0], weight=2.0, reference_style=ref)
    got = synthetic.grid_from_scene(GridParams(**p), pair[1], weight=2.0, reference_style=ref,
                                    device="cpu")
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-6, rtol=0, err_msg=k)


# --- raycast -------------------------------------------------------------------

def _both(jg, tg, params, jparams, cam, jpose, cfg=None, stride=1, with_color=True,
          warm=False, dirs=False):
    """The same render through both packages; ``warm`` renders once cold and
    then warm-starts from that render's range_t."""
    cfg = cfg or {}
    pose = pose_from_numpy(jpose.R, jpose.t, device="cpu")
    dirs_cam = None
    if dirs:  # a sheared lattice of camera-frame directions
        v, u = np.meshgrid(np.linspace(-0.5, 0.5, 30), np.linspace(-0.6, 0.6, 40), indexing="ij")
        dirs_cam = np.stack([u + 0.1 * v, v, np.ones_like(u)], -1).astype(np.float32)
    jkw = dict(params=jparams, cam=cam, cfg=JRaycastConfig(**cfg), stride=stride,
               with_color=with_color)
    tkw = dict(params=params, cam=cam, cfg=RaycastConfig(**cfg), stride=stride,
               with_color=with_color)
    if dirs:
        jkw["dirs_cam"], tkw["dirs_cam"] = jnp.asarray(dirs_cam), torch.from_numpy(dirs_cam)
    a = jraycast(jg, jpose, **jkw)
    b = raycast(tg, pose, **tkw)
    if warm:
        a = jraycast(jg, jpose, t_init=a.range_t, **jkw)
        b = raycast(tg, pose, t_init=b.range_t, **tkw)
    return a, b


def _assert_render_close(a, b, with_color=True):
    ha, hb = np.asarray(a.hit), b.hit.numpy()
    assert (ha == hb).mean() >= HIT_AGREE, ((ha != hb).sum(), ha.size)
    both = ha & hb
    assert both.sum() > 100
    for name, tol, tol_all in (("depth", TOL_DEPTH, TOL_DEPTH_ALL),
                               ("range_t", TOL_DEPTH, TOL_DEPTH_ALL),
                               ("normal_world", TOL_NORMAL, TOL_NORMAL_ALL),
                               ("normal_cam", TOL_NORMAL, TOL_NORMAL_ALL)):
        err = np.abs(np.asarray(getattr(a, name)) - getattr(b, name).numpy())[both]
        err = err.reshape(err.shape[0], -1).max(-1)
        assert (err <= tol).mean() >= VALUE_SHARE and err.max() <= tol_all, (name, err.max())
    for x in (b.depth, b.range_t, b.normal_world):
        assert torch.isnan(x[~b.hit]).all() and torch.isfinite(x[b.hit]).all()
    if with_color:
        err = np.abs(np.asarray(a.rgb) - b.rgb.numpy())[both].max(-1)
        assert (err <= TOL_RGB).mean() >= VALUE_SHARE, err.max()
    else:
        assert a.rgb is None and b.rgb is None
    assert (np.asarray(a.steps) == b.steps.numpy()).mean() >= STEPS_AGREE
    assert b.steps.dtype == torch.int32
    assert int(a.dropped) == int(b.dropped)


# 96x72 = 6,912 rays: two_phase "auto" is on here ("default"); the fused
# grid's cases set it "on" explicitly
RAYCAST_CASES = {
    "default": dict(),
    "trilinear": dict(cfg=dict(sample="trilinear")),
    "march": dict(cfg=dict(fine_mode="march")),
    "warm": dict(cfg=dict(t_near=0.05, t_far=4.0), warm=True),
    "stride2": dict(stride=2),
    "two_phase_off": dict(cfg=dict(two_phase="off")),
    "no_color": dict(with_color=False),
    "dirs_cam": dict(dirs=True),
}


@pytest.mark.parametrize("case", list(RAYCAST_CASES))
def test_raycast_matches_jax(case):
    jg, tg = sphere_grids()
    kw = RAYCAST_CASES[case]
    a, b = _both(jg, tg, PARAMS, JPARAMS, CAM, JPOSE, **kw)
    _assert_render_close(a, b, kw.get("with_color", True))


@pytest.mark.parametrize("case", ["default", "warm_stride2", "trilinear_two_phase_on"])
def test_raycast_fused_grid_matches_jax(case):
    """The fused grid: unobserved space, a truncated field, a wall behind."""
    jg, tg, params, jparams, cam, jpose = fused_grids()
    kw = {"default": dict(), "warm_stride2": dict(warm=True, stride=2),
          "trilinear_two_phase_on": dict(cfg=dict(sample="trilinear", two_phase="on"))}[case]
    a, b = _both(jg, tg, params, jparams, cam, jpose, **kw)
    _assert_render_close(a, b)


def test_raycast_dropped_matches_jax():
    """two_phase on, small steps: more rays outlive phase A than the
    compacted phase has slots; the same rays (the first K in ray order) get
    them, so hits and the dropped count agree."""
    jg, tg = sphere_grids()
    cfg = dict(sample="trilinear", two_phase="on", step_scale=0.3, max_steps=40)
    a, b = _both(jg, tg, PARAMS, JPARAMS, CAM, JPOSE, cfg=cfg)
    assert int(a.dropped) > 100 and int(b.dropped) == int(a.dropped)
    _assert_render_close(a, b)


def test_raycast_pose_gradient_matches_jax():
    """d(mean hit depth)/d(t_y) at stride 4 (tests/test_render.py's case)."""
    jg, tg = sphere_grids()

    def jf(ty):
        pose = JPose(JPOSE.R, JPOSE.t + ty * jnp.asarray([0.0, 1.0, 0.0]))
        r = jraycast(jg, pose, params=JPARAMS, cam=CAM, stride=4)
        return jnp.nansum(jnp.where(r.hit, r.depth, 0.0)) / jnp.sum(r.hit)

    want = float(jax.grad(jf)(jnp.float32(0.0)))
    ty = torch.zeros((), requires_grad=True)
    r = raycast(tg, Pose(POSE.R, POSE.t + ty * torch.tensor([0.0, 1.0, 0.0])), params=PARAMS,
                cam=CAM, stride=4)
    loss = torch.where(r.hit, r.depth, 0.0).sum() / r.hit.sum()
    loss.backward()
    assert (~r.hit).any()  # misses in the image
    assert -1.7 < want < -0.6
    np.testing.assert_allclose(ty.grad.item(), want, rtol=1e-3)


@pytest.mark.parametrize("grids", ["sphere", "fused"])
def test_raycast_depth_loss_gradient_wrt_D_matches_jax(grids):
    """d(sum over hits of (depth - 1)^2)/dD, per voxel, at stride 4."""
    if grids == "sphere":
        jg, tg, params, jparams, cam, jpose = (*sphere_grids(), PARAMS, JPARAMS, CAM, JPOSE)
    else:
        jg, tg, params, jparams, cam, jpose = fused_grids()

    def jf(D):
        r = jraycast(jg._replace(D=D), jpose, params=jparams, cam=cam, stride=4)
        return jnp.sum(jnp.where(r.hit, (r.depth - 1.0) ** 2, 0.0))

    want = np.asarray(jax.grad(jf)(jg.D))
    D = tg.D.clone().requires_grad_(True)
    grid = TSDFGrid(D, tg.W, tg.R, tg.G, tg.B, tg.Wc)
    r = raycast(grid, pose_from_numpy(jpose.R, jpose.t, device="cpu"), params=params, cam=cam,
                stride=4)
    torch.where(r.hit, (r.depth - 1.0) ** 2, 0.0).sum().backward()
    got = D.grad.numpy()
    assert np.isfinite(got).all() and (got != 0).sum() > 50
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_raycast_rotation_gradient_finite_with_misses():
    """The rotation gradient of a depth loss stays finite with misses in the
    image (the double-where at the refinement and the depth division), and
    agrees with jax.grad."""
    jg, tg = sphere_grids()

    def jf(R):
        r = jraycast(jg, JPose(R, JPOSE.t), params=JPARAMS, cam=CAM, stride=4,
                     with_color=True)
        return (jnp.sum(jnp.where(r.hit, r.depth, 0.0))
                + jnp.sum(jnp.where(r.hit[..., None], r.normal_cam, 0.0)))

    want = np.asarray(jax.grad(jf)(JPOSE.R))
    R = POSE.R.clone().requires_grad_(True)
    r = raycast(tg, Pose(R, POSE.t), params=PARAMS, cam=CAM, stride=4, with_color=True)
    loss = (torch.where(r.hit, r.depth, 0.0).sum()
            + torch.where(r.hit[..., None], r.normal_cam, 0.0).sum())
    loss.backward()
    assert (~r.hit).sum() > 100
    assert torch.isfinite(R.grad).all()
    np.testing.assert_allclose(R.grad.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_raycast_matches_analytic_depth():
    """The port alone against the exact sphere: the thresholds of
    tests/test_render.py (hit agreement > 0.97, median |err| < 5 mm, 95th
    percentile < 20 mm)."""
    _, tg = sphere_grids()
    r = raycast(tg, POSE, params=PARAMS, cam=CAM, with_color=True)
    exact = synthetic.render_scene_depth(synthetic.SphereScene(center=(0.0, 0.0, 0.0),
                                                               radius=0.5), CAM, POSE).numpy()
    hit, exact_hit = r.hit.numpy(), np.isfinite(exact)
    assert (hit == exact_hit).mean() > 0.97
    both = hit & exact_hit
    err = np.abs(r.depth.numpy()[both] - exact[both])
    assert both.sum() > 800 and np.median(err) < 0.005 and np.quantile(err, 0.95) < 0.02
    assert torch.isfinite(r.rgb[r.hit]).all()


def test_render_panels_match_jax_and_png_decodes(tmp_path):
    """render_panels on the same render equals the JAX package's byte for
    byte; the PNG written without PIL decodes to the panels."""
    jg, tg = sphere_grids()
    _, b = _both(jg, tg, PARAMS, JPARAMS, CAM, JPOSE)
    fields = {k: jnp.asarray(getattr(b, k).numpy()) for k in ("depth", "normal_world", "rgb")}
    want = jrender_panels(b._replace(**fields))
    got = render_panels(b)
    assert got.shape == (72, 96 * 3, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "r.png")
    save_render_png(b._replace(rgb=None), path)
    data, channels, bit_depth = decode_png(path)
    assert (channels, bit_depth) == (3, 8)
    np.testing.assert_array_equal(data, render_panels(b._replace(rgb=None)))
