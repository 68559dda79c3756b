"""The port's raycaster and marching tetrahedra on a CUDA GPU against the same
functions on the CPU, on a 64^3 sphere + box grid from grid_from_scene and a
96x72 camera.

Marked ``cuda``: each test skips without a card (decided inside the test, so
every pytest-xdist worker collects the same tests). On a GPU machine run
``python -m pytest --noconftest tests/test_torch_render_cuda.py -m cuda``.
Tolerances, those of tests/test_torch_render.py and tests/test_torch_mesh.py
(the card's float32 kernels may contract a multiply and an add where the
CPU's do not): hit masks equal on >= 99.9% of the pixels, on common hits
depth within 1e-4 m, normals within 1e-4 and rgb within 1e-5 on >= 99.5% of
them (all within 2e-3 m and 1e-2), steps equal on >= 99%, dropped equal;
meshes with equal triangle counts, vertices within 1e-6 (a triangle whose
winding test sits on zero may come back reversed: at most 0.1% of them),
colors within one uint8 step; the pose gradient to rtol 1e-3.
"""
import numpy as np
import pytest
import torch

from tracking_sdf_tpu_torch.config import GridParams, RaycastConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.data.synthetic import CuboidScene, SphereScene, grid_from_scene, look_at
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid
from tracking_sdf_tpu_torch.render.marching_cubes import marching_cubes
from tracking_sdf_tpu_torch.render.raycast import raycast

pytestmark = pytest.mark.cuda

PARAMS = GridParams(m=64, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                    delta=0.1, epsilon=0.01)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))


class _Union:
    def sdf(self, x):
        return torch.minimum(SPHERE.sdf(x), BOX.sdf(x))

    def color(self, x):
        return torch.where((SPHERE.sdf(x) <= BOX.sdf(x))[..., None], SPHERE.color(x),
                           BOX.color(x))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _grids(dev):
    cpu = grid_from_scene(PARAMS, _Union(), device="cpu")
    return cpu, TSDFGrid(*(getattr(cpu, k).to(dev) for k in FIELDS))


def _assert_render_close(a, b):
    ha, hb = a.hit, b.hit.cpu()
    assert (ha == hb).float().mean().item() >= 0.999
    both = ha & hb
    assert both.sum() > 100
    for name, tol, tol_all in (("depth", 1e-4, 2e-3), ("range_t", 1e-4, 2e-3),
                               ("normal_world", 1e-4, 1e-2), ("rgb", 1e-5, 1e-2)):
        e = (getattr(a, name) - getattr(b, name).cpu()).abs()[both]
        e = e.reshape(e.shape[0], -1).amax(-1)
        assert (e <= tol).float().mean().item() >= 0.995 and e.max().item() <= tol_all, name
    assert (a.steps == b.steps.cpu()).float().mean().item() >= 0.99
    assert int(a.dropped) == int(b.dropped)


@pytest.mark.parametrize("case", ["cold", "warm", "stride2", "trilinear_two_phase_on"])
def test_raycast_card_matches_cpu(dev, case):
    cpu, card = _grids(dev)
    pose = look_at((0.0, -1.6, 0.2), (0.0, 0.0, 0.0), device="cpu")
    cfg = (RaycastConfig(sample="trilinear", two_phase="on") if case == "trilinear_two_phase_on"
           else RaycastConfig(t_near=0.05, t_far=4.0))
    kw = dict(params=PARAMS, cam=CAM, cfg=cfg, with_color=True,
              stride=2 if case == "stride2" else 1)
    a = raycast(cpu, pose, **kw)
    b = raycast(card, pose.to(dev), **kw)
    if case == "warm":
        a = raycast(cpu, pose, t_init=a.range_t, **kw)
        b = raycast(card, pose.to(dev), t_init=b.range_t, **kw)
    assert b.depth.device.type == "cuda"
    _assert_render_close(a, b)


@pytest.mark.parametrize("case", ["trilinear", "shepard_quant", "chunked"])
def test_marching_cubes_card_matches_cpu(dev, case):
    from tracking_sdf_tpu_torch.render.marching_cubes import marching_cubes_chunked

    cpu, card = _grids(dev)
    kw = dict(with_colors=True)
    if case == "shepard_quant":
        kw.update(color_mode="shepard", vertex_quant=True)
    fn = marching_cubes_chunked if case == "chunked" else marching_cubes
    a, b = fn(cpu, params=PARAMS, **kw), fn(card, params=PARAMS, **kw)
    assert b.num_triangles == a.num_triangles > 1000 and b.dropped_cells == a.dropped_cells
    same = np.abs(a.vertices - b.vertices).reshape(-1, 9).max(-1)
    rev = np.abs(a.vertices - b.vertices[:, ::-1]).reshape(-1, 9).max(-1)
    assert np.minimum(same, rev).max() <= 1e-6
    assert ((same > 1e-6) & (rev <= 1e-6)).mean() <= 1e-3
    np.testing.assert_allclose(b.colors, a.colors, atol=1.0 / 255.0 + 1e-6, rtol=0)


def test_raycast_pose_gradient_card_matches_cpu(dev):
    cpu, card = _grids(dev)
    pose = look_at((0.0, -1.6, 0.2), (0.0, 0.0, 0.0), device="cpu")
    grads = []
    for grid, d in ((cpu, "cpu"), (card, dev)):
        ty = torch.zeros((), device=d, requires_grad=True)
        p = pose.to(d)
        r = raycast(grid, Pose(p.R, p.t + ty * torch.tensor([0.0, 1.0, 0.0], device=d)),
                    params=PARAMS, cam=CAM, stride=4)
        (torch.where(r.hit, r.depth, 0.0).sum() / r.hit.sum()).backward()
        grads.append(ty.grad.item())
    assert -1.7 < grads[0] < -0.6
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-3)
