"""The port's import surface against the JAX package's.

Every name that a JAX package ``__init__`` exports (its ``__all__``, or the
names it imports) resolves at the same path in the port, apart from
``parallel.grid_sharding`` and ``parallel.replicated_sharding``, which are
jax.sharding objects (the port's mesh holds slabs). The helpers that had no
counterpart compute what the JAX functions compute: ``pose_identity``,
``strided_points`` and ``orbit_poses`` to 1e-6 (NaN holes kept),
``make_fuse_fn`` and ``fuse_voxels`` within the dense loop's 1e-5
(tests/test_torch_dense.py), with at most 1e-4 of the voxels past it: a
voxel on a pixel boundary truncates to either pixel in XLA and PyTorch.
Then the JAX README's library example, translated, on the CPU at m=48, and
the rule that ``Reconstruction`` runs on the GPU unless asked for the CPU.
"""
import ast
import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_brickmajor import CAM, PARAMS, POSES, _frame
from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu.core import lie as jlie
from tracking_sdf_tpu.data import synthetic as jsyn
from tracking_sdf_tpu.fusion import fuse as jfuse
from tracking_sdf_tpu.grid.grid import empty_grid as jempty_grid
from tracking_sdf_tpu.tracking import gauss_newton as jgn
from tracking_sdf_tpu_torch import config
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid, empty_grid

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "grid", "fusion", "tracking", "render", "parallel", "pipeline",
               "data", "utils")
NOT_PORTED = {("parallel", "grid_sharding"), ("parallel", "replicated_sharding")}
ATOL, SHARE = 1e-5, 1e-4


def jax_exports(sub):
    """The public names of the JAX package's ``__init__`` of ``sub`` ("" for
    the top level): its ``__all__`` when it has one, else every name it
    imports or assigns."""
    path = os.path.join(REPO, "tracking_sdf_tpu", sub, "__init__.py")
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if t.id == "__all__":
                    return set(ast.literal_eval(node.value))
                names.add(t.id)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("sub", ("",) + SUBPACKAGES)
def test_every_jax_export_resolves_in_the_port(sub):
    names = jax_exports(sub)
    assert names
    mod = importlib.import_module("tracking_sdf_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in names if (sub, n) not in NOT_PORTED and not hasattr(mod, n))
    assert not missing, missing
    if sub:
        jmod = importlib.import_module(f"tracking_sdf_tpu.{sub}")
        assert set(getattr(jmod, "__all__", ())) - {n for s, n in NOT_PORTED} <= set(
            getattr(mod, "__all__", None) or names)


def test_top_level_is_lazy_like_jax():
    import tracking_sdf_tpu_torch as port

    assert port.preset is config.preset and port.config is config
    assert port.__version__ == "0.1.0"
    for sub in SUBPACKAGES:
        assert sub in dir(port) and getattr(port, sub).__name__ == f"tracking_sdf_tpu_torch.{sub}"
    with pytest.raises(AttributeError):
        port.no_such_subpackage


def test_modules_shadowed_by_functions_stay_reachable():
    """render's ``raycast`` and ``marching_cubes`` are the functions, as in
    the JAX package; importlib still reaches the modules."""
    from tracking_sdf_tpu_torch import render

    for name in ("raycast", "marching_cubes"):
        assert callable(getattr(render, name)) and not hasattr(getattr(render, name), "__file__")
        mod = importlib.import_module(f"tracking_sdf_tpu_torch.render.{name}")
        assert mod.__file__.endswith(f"{name}.py") and getattr(mod, name) is getattr(render, name)
    assert hasattr(importlib.import_module("tracking_sdf_tpu_torch.render.raycast"), "_leap")


def test_pose_identity_matches_jax():
    from tracking_sdf_tpu_torch.core import pose_identity

    p, j = pose_identity(device="cpu"), jlie.pose_identity()
    assert p.R.dtype == torch.float32
    np.testing.assert_array_equal(p.R.numpy(), np.asarray(j.R))
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))


def test_strided_points_matches_jax():
    from tracking_sdf_tpu_torch.tracking import strided_points

    img = np.random.default_rng(7).normal(size=(31, 40, 3)).astype(np.float32)
    img[np.random.default_rng(8).random((31, 40)) < 0.2] = np.nan
    got = strided_points(torch.from_numpy(img), 3).numpy()
    want = np.asarray(jgn.strided_points(jnp.asarray(img), 3))
    assert got.shape == want.shape == (11 * 14, 3)
    np.testing.assert_array_equal(got, want)  # NaN where NaN


def test_orbit_poses_match_jax():
    from tracking_sdf_tpu_torch.data import orbit_poses

    got = orbit_poses(5, 1.5, 0.3, target=(0.1, 0.2, 0.0), arc=2.0, device="cpu")
    want = jsyn.orbit_poses(5, 1.5, 0.3, target=(0.1, 0.2, 0.0), arc=2.0)
    assert len(got) == len(want) == 5
    for p, j in zip(got, want):
        np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), atol=1e-6)
        np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), atol=1e-6)


def _assert_grids_close(got, want):
    for k in FIELDS:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        past = np.abs(a - b) > ATOL
        assert past.mean() <= SHARE, (k, int(past.sum()), float(np.abs(a - b).max()))


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_make_fuse_fn_matches_jax(distance):
    from tracking_sdf_tpu_torch.fusion import make_fuse_fn

    jcfg, tcfg = (pkg.FusionConfig(distance=distance) for pkg in (jconfig, config))
    jfn = jfuse.make_fuse_fn(PARAMS, CAM, jcfg)
    tfn = make_fuse_fn(config.GridParams(*PARAMS), CAM, tcfg)
    jg, tg = jempty_grid(PARAMS), empty_grid(PARAMS, device="cpu")
    for i, pose in enumerate(POSES):
        pts, nrm, rgb = _frame(pose, i)
        jg = jfn(jg, pose, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(rgb))
        tg = tfn(tg, pose_from_numpy(pose.R, pose.t, device="cpu"), torch.from_numpy(pts),
                 torch.from_numpy(nrm), torch.from_numpy(rgb))
    assert (tg.W > 0).float().mean() > 0.05 and (tg.Wc > 0).sum() > 100
    _assert_grids_close(tg, jg)


def test_fuse_voxels_matches_jax_on_a_slab():
    """The per-voxel pass over a slab of 16 planes at i_offset 16 from a
    pixel table, on a grid that one frame has already fused."""
    from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame, fuse_voxels, pixel_channels

    jcfg, tcfg = jconfig.FusionConfig(), config.FusionConfig()
    tparams = config.GridParams(*PARAMS)
    pts0, nrm0, rgb0 = _frame(POSES[0], 0)
    jg = jfuse.fuse_frame(jempty_grid(PARAMS), POSES[0], jnp.asarray(pts0), jnp.asarray(nrm0),
                          jnp.asarray(rgb0), params=PARAMS, cam=CAM, cfg=jcfg)
    tg = fuse_frame(empty_grid(tparams, device="cpu"),
                    pose_from_numpy(POSES[0].R, POSES[0].t, device="cpu"),
                    torch.from_numpy(pts0), torch.from_numpy(nrm0), torch.from_numpy(rgb0),
                    params=tparams, cam=CAM, cfg=tcfg)
    sl = slice(16, 32)
    jslab = type(jg)(*(x[sl] for x in jg))
    tslab = TSDFGrid(*(getattr(tg, k)[sl] for k in FIELDS))
    pts, nrm, rgb = _frame(POSES[1], 1)
    jpix = jfuse.pixel_channels(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(rgb), jcfg)
    tpix = pixel_channels(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(rgb),
                          tcfg)
    np.testing.assert_allclose(tpix.numpy(), np.asarray(jpix), atol=1e-6)
    want = jfuse.fuse_voxels(jslab, POSES[1], jpix, pts.shape[:2], params=PARAMS, cam=CAM,
                             cfg=jcfg, i_offset=16)
    got = fuse_voxels(tslab, pose_from_numpy(POSES[1].R, POSES[1].t, device="cpu"), tpix,
                      pts.shape[:2], params=tparams, cam=CAM, cfg=tcfg, i_offset=16)
    assert got.D.shape == (16, PARAMS.m, PARAMS.m) and bool((got.W > tslab.W).any())
    _assert_grids_close(got, want)


def test_readme_library_example_on_the_cpu(tmp_path, monkeypatch):
    """The JAX README's library example with the port's package name, on a
    generated 640x480 sequence (the fr1 camera's intrinsics) with the
    tum256 preset shrunk to m=48, on the CPU (the preset writes
    trajectory.txt into the working directory)."""
    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.core.camera import tum_fr1_camera
    from tracking_sdf_tpu_torch.data.make_sequence import generate
    from tracking_sdf_tpu_torch.data.tum import TUMDataset
    from tracking_sdf_tpu_torch.pipeline import Reconstruction

    root = str(tmp_path / "seq")
    generate(root, n_frames=3, noise_k=0.0, dropout=0.0, device="cpu")
    dataset = TUMDataset(root)
    cfg = preset("tum256")
    cfg = dataclasses.replace(cfg, grid=cfg.grid._replace(m=48))
    monkeypatch.chdir(tmp_path)

    recon = Reconstruction(tum_fr1_camera(), cfg, device="cpu")
    for frame in dataset:
        recon.process_frame(frame.depth, frame.rgb, timestamp=frame.timestamp)
    render = recon.render()
    n_tri = recon.export_mesh("scene.ply")
    assert recon.frame_num == 3 and not any(s.rejected for s in recon.stats)
    assert render.depth.shape == (480, 640) and bool(render.hit.any())
    recon.close()
    assert n_tri > 0 and (tmp_path / "scene.ply").read_bytes().startswith(b"ply\n")
    assert len((tmp_path / "trajectory.txt").read_text().splitlines()) == 3


def test_reconstruction_without_device_runs_on_the_gpu(monkeypatch):
    """Without ``device=`` the entry point takes the GPU; with none it
    raises, naming device="cpu", and never falls back to the CPU."""
    from tracking_sdf_tpu_torch.core.camera import tum_fr1_camera
    from tracking_sdf_tpu_torch.pipeline import Reconstruction

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Reconstruction(tum_fr1_camera(), config.preset("tum256"))
    assert Reconstruction(tum_fr1_camera(), dataclasses.replace(
        config.preset("tum256"), grid=config.GridParams(m=16), trajectory_path=None),
        device="cpu").device.type == "cpu"
