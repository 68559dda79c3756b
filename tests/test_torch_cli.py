"""The port's CLI on a generated TUM directory against the JAX package's CLI
on the same directory, on the CPU (tests/test_torch_cli_modes.py holds the
port's other modes).

Sizes: 8 frames at 160x120 from the port's generator, and the m=96
brick-major bf16 configuration of tests/test_make_sequence.py over the tum
volume, with the separable bilateral filter (the one the port runs); both
packages' ``preset`` is replaced by it, as that test does. Tolerances:
  * the two CLIs: ``frames`` and ``ate_pairs`` equal, trajectory lines
    within 1e-4 m (and quaternions 1e-4), ATE within 1 mm and under 0.05 m
    (a working tracker stays within half of the 62 mm voxel);
  * the port's chunked run on the raw stream against its per-frame run:
    bitwise (trajectory file and rows);
  * groundtruth-pose mode: the same voxels observed, and every dense leaf
    within atol 1e-5 on at least 99% of the observed voxels, with float32
    and with bf16 values. The rest (measured 0.2-0.5%) are voxels whose
    centre projects onto a pixel boundary, where the product's last bit
    picks the pixel: frame 0's pose is axis-aligned, so such ties are
    common in it. They take a neighbouring pixel's noisy depth and normal
    in one package, or lose one observation at the truncation boundary, and
    are held to |dD| <= 0.02 m, |dW| <= 1 and |dWc| <= 1.
"""
import io
import json
import os
import shutil
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import tracking_sdf_tpu.pipeline as jpipeline
from tracking_sdf_tpu import cli as jcli
from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu_torch import cli, config
from tracking_sdf_tpu_torch.data.make_sequence import generate
from tracking_sdf_tpu_torch.pipeline import runner

torch.set_num_threads(2)


def small_config(package, **fusion):
    return package.PipelineConfig(
        grid=package.GridParams(m=96), bilateral_mode="separable",
        fusion=package.FusionConfig(mode="brickmajor", brick_shape=(8, 8, 8),
                                    brick_cap=1728, brick_cap_free=1728,
                                    pixel_share=2, pixel_share_j=2,
                                    **{"storage_dtype": "bfloat16", **fusion}))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tum_synth"))
    stats = generate(root, n_frames=8, width=160, height=120, noise_k=1.0e-3,
                     dropout=0.01, seed=3, device="cpu")
    return root, stats


def camera_arg(stats):
    return ",".join(str(v) for v in stats["camera"])


class Run:
    """One CLI call: its exit code, the JSON summary, stderr, the trajectory
    path and the Reconstruction objects it made."""

    def __init__(self, module, argv, tmp_path, name, monkeypatch, fusion=None):
        package, target, attr = ((jconfig, jpipeline, "Reconstruction") if module is jcli
                                 else (config, runner, "Reconstruction"))
        monkeypatch.setattr(package, "preset",
                            lambda preset_name: small_config(package, **(fusion or {})))
        made = self.made = []
        base = getattr(target, attr)

        class Spy(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        monkeypatch.setattr(target, attr, Spy)
        self.trajectory = str(tmp_path / f"{name}.txt")
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            self.rc = module.main(argv + ["--trajectory", self.trajectory, "--json", "--cpu"])
        monkeypatch.setattr(target, attr, base)
        self.stderr = err.getvalue()
        lines = out.getvalue().strip().splitlines()
        self.summary = json.loads(lines[-1]) if lines else None

    @property
    def recon(self):
        return self.made[-1]

    def lines(self):
        return np.loadtxt(self.trajectory, ndmin=2)


_RUNS = {}


def per_frame_run(sequence, tmp_path_factory, monkeypatch):
    """The port's per-frame run over the sequence, made once for the module."""
    if "per_frame" not in _RUNS:
        root, stats = sequence
        _RUNS["per_frame"] = Run(
            cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval"],
            tmp_path_factory.mktemp("per_frame"), "port", monkeypatch)
    return _RUNS["per_frame"]


def test_cli_matches_jax(sequence, tmp_path, tmp_path_factory, monkeypatch):
    root, stats = sequence
    ours = per_frame_run(sequence, tmp_path_factory, monkeypatch)
    theirs = Run(jcli, ["--dataset", root, "--camera", camera_arg(stats), "--eval"],
                 tmp_path, "jax", monkeypatch)
    assert ours.rc == theirs.rc == 0
    so, sj = ours.summary, theirs.summary
    assert so["frames"] == sj["frames"] == 8 and so["ate_pairs"] == sj["ate_pairs"] == 8
    to, tj = ours.lines(), theirs.lines()
    np.testing.assert_array_equal(to[:, 0], tj[:, 0])
    np.testing.assert_allclose(to[:, 1:4], tj[:, 1:4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to[:, 4:], tj[:, 4:], rtol=0, atol=1e-4)
    assert abs(so["ate_rmse_m"] - sj["ate_rmse_m"]) < 1e-3
    assert so["ate_rmse_m"] < 0.05 and sj["ate_rmse_m"] < 0.05
    assert abs(so["rpe_trans_m"] - sj["rpe_trans_m"]) < 1e-3
    assert abs(so["gn_iters_mean"] - sj["gn_iters_mean"]) < 1e-9
    assert set(sj) <= set(so)  # the JAX summary's keys, and the port's own beside them
    assert not any(s.rejected for s in ours.recon.stats)
    assert so["overflow_drops"] == 0 and so["run_frames"] == 8 and so["run_s"] > 0


def test_native_chunk_equals_per_frame(sequence, tmp_path, tmp_path_factory, monkeypatch):
    """``--native-loader --chunk 4``: frame 0 per frame, frames 1-4 as one
    chunk of raw uint16 / uint8 frames decoded in the chunk step, the odd
    tail 5-7 per frame (raw too). Trajectory file and rows equal the
    per-frame run's on float frames, bit for bit."""
    root, stats = sequence
    ref = per_frame_run(sequence, tmp_path_factory, monkeypatch)
    seen = []
    process_chunk = runner.Reconstruction.process_chunk

    def spy(self, depths, rgbs=None, timestamps=None):
        seen.append((depths.dtype, depths.shape, rgbs.dtype))
        return process_chunk(self, depths, rgbs, timestamps)

    monkeypatch.setattr(runner.Reconstruction, "process_chunk", spy)
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval",
                    "--native-loader", "--chunk", "4"], tmp_path, "chunk", monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 8 and got.summary["ate_pairs"] == 8
    assert seen == [(np.dtype("uint16"), (4, 120, 160), np.dtype("uint8"))]
    with open(ref.trajectory) as a, open(got.trajectory) as b:
        assert a.read() == b.read()
    assert got.summary["ate_rmse_m"] == ref.summary["ate_rmse_m"]
    for k in ("D", "W", "C"):
        x, y = getattr(ref.recon.brick_grid, k), getattr(got.recon.brick_grid, k)
        assert torch.equal(x.view(torch.int16), y.view(torch.int16)), k
    assert [s.gn_iterations for s in got.recon.stats] == [
        s.gn_iterations for s in ref.recon.stats]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_groundtruth_poses_match_jax(sequence, tmp_path, monkeypatch, storage):
    """``--groundtruth-poses``: nothing is tracked, every frame fuses at its
    groundtruth pose, and the final grids agree with the JAX package's."""
    root, stats = sequence
    argv = ["--dataset", root, "--camera", camera_arg(stats), "--groundtruth-poses"]
    fusion = dict(storage_dtype=storage)
    ours = Run(cli, argv, tmp_path, "port", monkeypatch, fusion)
    theirs = Run(jcli, argv, tmp_path, "jax", monkeypatch, fusion)
    assert ours.rc == theirs.rc == 0 and ours.summary["frames"] == 8
    assert all(s.gn_iterations == 0 and not s.rejected for s in ours.recon.stats)
    np.testing.assert_allclose(ours.lines(), theirs.lines(), rtol=0, atol=1e-6 + 1e-12)
    gt, gj = ours.recon.grid, theirs.recon.grid
    W_j = np.asarray(gj.W)
    seen = W_j > 0
    assert seen.mean() > 0.01
    np.testing.assert_array_equal(gt.W.numpy() > 0, seen)
    for k, worst in (("D", 0.02), ("W", 1.0), ("R", 0.02), ("G", 0.02), ("B", 0.02),
                     ("Wc", 1.0)):
        diff = np.abs(getattr(gt, k).numpy() - np.asarray(getattr(gj, k)))[seen]
        assert (diff > 1e-5).mean() <= 0.01, (k, (diff > 1e-5).mean())
        assert diff.max() <= worst + 1e-5, (k, diff.max())
    assert (ours.recon.brick_grid.D.dtype == torch.bfloat16) == (storage == "bfloat16")


def test_groundtruth_gap_rejects_the_frame(sequence, tmp_path, monkeypatch):
    """A frame with no groundtruth pose within max_dt is dropped in the
    oracle mode (nothing is tracked in its place); without groundtruth.txt
    the mode is refused."""
    root, stats = sequence
    gap = str(tmp_path / "gap")
    shutil.copytree(root, gap)
    with open(os.path.join(gap, "groundtruth.txt")) as f:
        lines = f.read().splitlines()
    body = [i for i, x in enumerate(lines) if not x.startswith("#")]
    del lines[body[3]]
    with open(os.path.join(gap, "groundtruth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log = str(tmp_path / "metrics.jsonl")
    got = Run(cli, ["--dataset", gap, "--camera", camera_arg(stats), "--groundtruth-poses",
                    "--chunk", "4", "--frames", "6", "--metrics-log", log, "--eval"],
              tmp_path, "gap", monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 6
    with open(log) as f:
        rows = [json.loads(x) for x in f]
    assert [r["rejected"] for r in rows] == [False, False, False, True, False, False]
    assert len(got.lines()) == 5 and got.summary["ate_pairs"] == 5
    assert got.summary["ate_rmse_m"] < 1e-5  # the poses are the groundtruth's
    os.remove(os.path.join(gap, "groundtruth.txt"))
    refused = Run(cli, ["--dataset", gap, "--groundtruth-poses"], tmp_path, "none", monkeypatch)
    assert refused.rc == 2 and "groundtruth.txt" in refused.stderr and not refused.made
