"""The port's sequence generator against the JAX package's, on the CPU.

Both write the same arguments to disk at 160x120, 8 frames. Held, per case:
  * groundtruth.txt equal to 1e-6 (one unit of its six decimals);
  * depth PNGs equal except on at most 0.2% of a frame's pixels, and there
    by one step of the 16-bit quantizer (0.2 mm): a float32 rounding of the
    rendered depth that crosses a rounding boundary; holes equal elsewhere.
    (A hole can only move where the noise-free depth itself crosses the
    sensor's edge cases; none does in these scenes, so holes are held equal
    everywhere.) With the sensor pathologies on, the edge tests compare
    depths against thresholds, so a pixel may differ by more there: at most
    0.2% of pixels may differ at all, by any amount. In the thin-structure
    plant scene a ray that grazes a stem sphere can hit it in one package
    and the surface behind it in the other: there at most 3 pixels of a
    frame (0.016%) may differ by more than one step, and as many in color;
  * colors within 1/255.
The noise field is the same in both: one numpy generator, drawn in one order.
"""
import numpy as np
import pytest
from PIL import Image

from tracking_sdf_tpu.data import make_sequence as jms
from tracking_sdf_tpu_torch.data import make_sequence as tms
from tracking_sdf_tpu_torch.data.tum import TUMDataset, _read_listing

SIZE = dict(n_frames=8, width=160, height=120)


def trajectory_file(path):
    """A 100 Hz handheld-like trajectory over 2 s that looks around."""
    t = np.arange(0.0, 2.0, 0.01)
    lines = ["# timestamp tx ty tz qx qy qz qw"]
    for s in t:
        ang = 0.6 * np.sin(1.3 * s)
        q = (0.0, np.sin(ang / 2) * 0.6, np.sin(ang / 2) * 0.8, np.cos(ang / 2))
        p = (1.3 + 0.2 * np.sin(s), 0.6 + 0.1 * s, 1.5 + 0.05 * np.cos(3 * s))
        lines.append(f"{1305031.0 + s:.4f} " + " ".join(f"{v:.5f}" for v in p + q))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


CASES = {
    "tabletop": dict(seed=3, noise_k=1.0e-3, dropout=0.01),
    "desk": dict(seed=5, noise_k=1.0e-3, dropout=0.01, scene_family="desk"),
    "plant": dict(seed=5, noise_k=1.0e-3, dropout=0.01, scene_family="plant"),
    "room": dict(seed=1, room=True),
    "clean": dict(seed=2, noise_k=0.0, dropout=0.0),
    "pathology": dict(seed=3, noise_k=1.0e-3, dropout=0.0, pathology=True),
    "burst": dict(seed=4, burst=(3, 2, 0.95)),
    "trajectory_file": dict(seed=6, room=True, traj_fps=10.0, traj_start=0.5,
                            fit_trajectory=True, trajectory_file=True),
}


def pngs(root, listing):
    return [np.asarray(Image.open(f"{root}/{name}")).astype(np.int64)
            for _, name in _read_listing(f"{root}/{listing}")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_jax(tmp_path, case):
    kw = dict(CASES[case])
    if kw.get("trajectory_file"):
        kw["trajectory_file"] = trajectory_file(tmp_path / "traj.txt")
    rj, rt = str(tmp_path / "jax"), str(tmp_path / "port")
    sj = jms.generate(rj, **SIZE, **kw)
    st = tms.generate(rt, **SIZE, **kw, device="cpu")
    assert st["frames"] == sj["frames"] == 8
    np.testing.assert_allclose(st["camera"], sj["camera"], rtol=1e-7)
    assert abs(st["min_valid_frac"] - sj["min_valid_frac"]) <= 0.002
    for name in ("depth.txt", "rgb.txt"):
        with open(f"{rj}/{name}") as a, open(f"{rt}/{name}") as b:
            assert a.read() == b.read()
    gj = np.loadtxt(f"{rj}/groundtruth.txt")
    gt = np.loadtxt(f"{rt}/groundtruth.txt")
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1.0e-6 + 1e-12)
    exact = not kw.get("pathology")
    for i, (dj, dt) in enumerate(zip(pngs(rj, "depth.txt"), pngs(rt, "depth.txt"))):
        assert dt.shape == (120, 160)
        differ = dj != dt
        assert differ.mean() <= 0.002, (i, differ.mean())
        if case == "plant":
            assert (np.abs(dj - dt) > 1).sum() <= 3, i
            np.testing.assert_array_equal(dj == 0, dt == 0)
        elif exact:
            assert np.abs(dj - dt).max() <= 1, i
            np.testing.assert_array_equal(dj == 0, dt == 0)
    for i, (cj, ct) in enumerate(zip(pngs(rj, "rgb.txt"), pngs(rt, "rgb.txt"))):
        assert ct.shape == (120, 160, 3)
        if case == "plant":
            assert (np.abs(cj - ct).max(axis=-1) > 1).sum() <= 3, i
        else:
            assert np.abs(cj - ct).max() <= 1, i
    if case == "burst":
        valid = [(d > 0).mean() for d in pngs(rt, "depth.txt")]
        assert max(valid[3:5]) < 0.1 and min(valid[:3] + valid[5:]) > 0.9
    if case == "trajectory_file":
        assert np.linalg.norm(gt[-1, 1:4] - gt[0, 1:4]) > 1e-3
    np.testing.assert_allclose(gt[0, 1:4], [0.0, 0.0, 1.0], atol=1e-5)


def test_sequence_layout_and_groundtruth(tmp_path):
    """The port's own directory through the port's TUMDataset: sizes, the
    16-bit depth range and frame 0 at the runner's initial pose."""
    root = str(tmp_path / "seq")
    stats = tms.generate(root, **SIZE, noise_k=1.0e-3, dropout=0.01, seed=3, device="cpu")
    assert stats["min_valid_frac"] > 0.9
    ds = TUMDataset(root)
    assert len(ds) == 8 and len(ds.groundtruth.timestamps) == 8
    f0 = ds[0]
    assert f0.depth.shape == (120, 160) and f0.rgb.shape == (120, 160, 3)
    assert np.isfinite(f0.depth).mean() > 0.9 and np.nanmax(f0.depth) < 65535 / 5000.0
    np.testing.assert_allclose(f0.gt_pose[0], [0.0, 0.0, 1.0], atol=1e-5)
    assert 0.0 <= f0.rgb.min() and f0.rgb.max() <= 1.0 and f0.rgb.std() > 0.05


def test_pathology_artifacts_present(tmp_path):
    """The four sensor pathologies show in the port's frames: new holes
    (shadows and patches), flying pixels moved by centimetres, and a gain
    that differs between frames."""
    kw = dict(**SIZE, noise_k=1.0e-3, dropout=0.0, seed=3, device="cpu")
    tms.generate(str(tmp_path / "p"), pathology=True, **kw)
    tms.generate(str(tmp_path / "c"), **kw)
    ds, clean = TUMDataset(str(tmp_path / "p")), TUMDataset(str(tmp_path / "c"))
    d_p, d_c = ds[2].depth, clean[2].depth
    assert (np.isnan(d_p) & ~np.isnan(d_c)).mean() > 0.01
    both = np.isfinite(d_p) & np.isfinite(d_c)
    assert (np.abs(d_p - d_c)[both] > 0.05).sum() > 20
    assert abs(float(ds[2].rgb.mean()) - float(ds[6].rgb.mean())) > 0.01


def test_ir_shadow_on_background_side():
    """The occlusion shadow falls on the background just right of a near
    occluder (the projector is left of the camera)."""
    z = np.full((4, 120), 3.0, np.float32)
    z[:, 40:60] = 1.0  # near strip
    m = tms._ir_shadow_mask(z, fx=100.0, baseline=0.075)
    # c = fx*b = 7.5: near u_p = u + 7.5, far u_p = u + 2.5, so the band is
    # the far pixels u in [60, 64] (u + 2.5 <= 59 + 7.5)
    assert m[0, 60:64].all(), m[0, 55:70]
    assert not m[0, 65:].any()
    assert not m[0, 40:60].any() and not m[0, :40].any()
    np.testing.assert_array_equal(m, jms._ir_shadow_mask(z, fx=100.0, baseline=0.075))


@pytest.mark.parametrize("fn", ["_flying_pixels", "_reflective_patches", "_exposure_rgb"])
def test_pathology_functions_match_jax(fn):
    """The copied numpy pathology functions draw the same numbers."""
    rng = np.random.default_rng(9)
    z = rng.uniform(0.5, 3.0, size=(30, 40)).astype(np.float32)
    z[:, 20:] += 1.0
    z[5:8, 5:9] = np.nan
    out = []
    for mod in (tms, jms):
        r = np.random.default_rng(11)
        if fn == "_flying_pixels":
            out.append(mod._flying_pixels(z, r))
        elif fn == "_reflective_patches":
            walkers = [[10.0, 12.0], [25.0, 30.0]]
            out.append(np.concatenate([mod._reflective_patches(z, r, walkers).ravel(),
                                       np.ravel(walkers)]))
        else:
            out.append(mod._exposure_rgb(np.stack([z, z, z], -1) / 4.0, 7, r))
    np.testing.assert_array_equal(out[0], out[1])


def test_scene_intersect_is_the_nearest_hit():
    """_Scene.intersect (the nanmin over objects) and intersect_argmin agree,
    and where every object misses both give NaN."""
    import torch

    scene, cam, pose0 = tms._build(160, 120)
    from tracking_sdf_tpu_torch.core.camera import pixel_rays
    from tracking_sdf_tpu_torch.core.lie import pose_apply

    dirs, _ = pixel_rays(cam, device="cpu")
    d_world = pose_apply(tms.Pose(pose0.R, torch.zeros(3)), dirs)
    origins = pose0.t.expand(d_world.shape)
    t, idx = scene.intersect_argmin(origins, d_world)
    torch.testing.assert_close(scene.intersect(origins, d_world), t, equal_nan=True,
                               rtol=0, atol=0)
    assert int(idx.max()) > 1 and bool(torch.isfinite(t).all())
    up = torch.tensor([[0.0, 0.0, -1.0]])  # camera -y, away from the floor: open sky
    t_up, idx_up = scene.intersect_argmin(pose0.t[None], up)
    assert bool(torch.isnan(t_up).all()) and int(idx_up) == 0
    assert bool(torch.isnan(scene.intersect(pose0.t[None], up)).all())


def test_parse_burst_and_main(tmp_path, capsys):
    assert tms._parse_burst(None) is None and tms._parse_burst("") is None
    assert tms._parse_burst("3:2") == (3, 2, 0.95) == jms._parse_burst("3:2")
    assert tms._parse_burst("5:4:0.5") == (5, 4, 0.5)
    out = str(tmp_path / "cli_seq")
    rc = tms.main(["--out", out, "--frames", "2", "--width", "80", "--height", "60",
                   "--scene", "desk", "--cpu"])
    assert rc == 0 and "wrote 2 frames" in capsys.readouterr().out
    assert len(TUMDataset(out)) == 2
    with pytest.raises(ValueError):
        tms.generate(str(tmp_path / "x"), n_frames=1, scene_family="garden", device="cpu")
    with pytest.raises(SystemExit):  # the file is too short for the frames asked
        tms.generate(str(tmp_path / "y"), n_frames=50, device="cpu", traj_fps=10.0,
                     trajectory_file=trajectory_file(tmp_path / "t.txt"))
