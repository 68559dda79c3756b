"""The port's CLI in its other modes, on the CPU: scene families, frame
subsampling, the synthetic orbit, realtime pacing, checkpoint and resume,
profiling, a mode that is not run, its parser against the JAX
package's, and the device rule. Sizes and the m=96 configuration are those of
tests/test_torch_cli.py; ATE bounds are its 0.05 m (half a 62 mm voxel and
far under the centimetres a lost tracker shows).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_cli import Run, camera_arg, sequence  # noqa: F401 (a fixture)
from tracking_sdf_tpu import cli as jcli
from tracking_sdf_tpu_torch import cli
from tracking_sdf_tpu_torch.data import native
from tracking_sdf_tpu_torch.data.make_sequence import generate
from tracking_sdf_tpu_torch.utils.profiling import Timer, device_timer, trace

torch.set_num_threads(2)


@pytest.mark.parametrize("family", ["desk", "plant"])
def test_scene_family_tracks_end_to_end(family, tmp_path, monkeypatch):
    root = str(tmp_path / family)
    stats = generate(root, n_frames=8, width=160, height=120, noise_k=1.0e-3,
                     dropout=0.01, seed=5, scene_family=family, device="cpu")
    assert stats["min_valid_frac"] > 0.85
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval"],
              tmp_path, "traj", monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 8 and got.summary["ate_pairs"] == 8
    assert got.summary["ate_rmse_m"] < 0.05, (family, got.summary)


@pytest.mark.parametrize("loader", [[], ["--native-loader", "--chunk", "2"]],
                         ids=["indexed", "native_chunk2"])
def test_frame_step(sequence, tmp_path, monkeypatch, loader):  # noqa: F811
    """``--frame-step 2`` processes frames 0, 2, 4, 6, also through the
    native stream (which is handed just those files)."""
    root, stats = sequence
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval",
                    "--frame-step", "2"] + loader, tmp_path, "step", monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 4 and got.summary["ate_pairs"] == 4
    stamps = got.lines()[:, 0]
    np.testing.assert_allclose(np.diff(stamps), 2.0 / 30.0, atol=1e-5)
    assert got.summary["ate_rmse_m"] < 0.05


def test_synthetic_orbit(tmp_path, monkeypatch):
    """``--synthetic``: no dataset; the groundtruth for --eval comes from the
    frames' own poses."""
    got = Run(cli, ["--synthetic", "--frames", "4", "--pixel-stride", "4", "--eval"],
              tmp_path, "synthetic", monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 4 and got.summary["ate_pairs"] == 4
    assert got.summary["ate_rmse_m"] < 0.05, got.summary
    assert got.recon.cam.width == 256 and got.recon.config.tracking.pixel_stride == 4


def test_realtime_ignores_chunk_and_counts_drops(sequence, tmp_path, monkeypatch):  # noqa: F811
    """At 1000 Hz the CPU cannot keep up: after the two warm-up frames the
    pacer drops to the newest frame. ``--chunk`` is ignored with a warning;
    yielded + dropped is the sequence's length."""
    root, stats = sequence
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval",
                    "--realtime", "1000", "--chunk", "4"], tmp_path, "rt", monkeypatch)
    assert got.rc == 0 and "ignoring --chunk" in got.stderr
    s = got.summary
    assert s["realtime_yielded"] + s["realtime_dropped"] == 8
    assert s["realtime_yielded"] == s["frames"] >= 3 and s["realtime_dropped"] >= 1
    assert f"{int(s['realtime_dropped'])} dropped stale at 1000 Hz" in got.stderr


def test_checkpoint_and_resume(sequence, tmp_path, monkeypatch):  # noqa: F811
    """``--checkpoint C --checkpoint-every 4 --frames 4`` and then the same
    without ``--frames``: the second call resumes at frame 4, and the
    trajectory file and the rows end equal to one uninterrupted run's."""
    root, stats = sequence
    base = ["--dataset", root, "--camera", camera_arg(stats), "--eval", "--native-loader",
            "--chunk", "3"]
    whole = Run(cli, base, tmp_path, "whole", monkeypatch)
    ck = ["--checkpoint", str(tmp_path / "ck"), "--checkpoint-every", "4"]
    first = Run(cli, base + ck + ["--frames", "4"], tmp_path, "parts", monkeypatch)
    assert first.rc == 0 and first.summary["frames"] == 4 and "resumed" not in first.stderr
    with open(tmp_path / "ck" / "meta.json") as f:
        assert json.load(f)["frame_num"] == 4
    second = Run(cli, base + ck, tmp_path, "parts", monkeypatch)
    assert second.rc == 0 and "at frame 4" in second.stderr
    assert second.summary["frames"] == 4 and second.summary["ate_pairs"] == 8
    with open(whole.trajectory) as a, open(second.trajectory) as b:
        assert a.read() == b.read()
    for k in ("D", "W", "C"):
        x, y = getattr(whole.recon.brick_grid, k), getattr(second.recon.brick_grid, k)
        assert torch.equal(x.view(torch.int16), y.view(torch.int16)), k
    assert second.summary["ate_rmse_m"] == whole.summary["ate_rmse_m"]


def test_profile_metrics_log_and_null_ate(sequence, tmp_path, monkeypatch):  # noqa: F811
    """``--profile DIR`` leaves a Chrome trace, ``--metrics-log`` one JSON
    line a frame, ``--no-color`` reads no color; with one frame the ATE is
    undefined and prints as null."""
    root, stats = sequence
    log = str(tmp_path / "m.jsonl")
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval", "--frames",
                    "1", "--no-color", "--no-bilateral", "--profile", str(tmp_path / "prof"),
                    "--metrics-log", log], tmp_path, "one", monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 1
    assert got.summary["ate_rmse_m"] is None and got.summary["ate_pairs"] == 1
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 1000
    with open(log) as f:
        assert [json.loads(x)["index"] for x in f] == [1]
    cfg = got.recon.config
    assert not cfg.fusion.fuse_color and not cfg.bilateral_filter


def test_config_overrides(sequence, tmp_path, monkeypatch):  # noqa: F811
    root, stats = sequence
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--frames", "1",
                    "--brick-cap", "512", "--brick-cap-free", "300", "--color-every", "3",
                    "--max-weight", "0", "--distance", "point_to_point", "--pixel-share", "4",
                    "--share-safe-classify", "off", "--weight-dtype", "bfloat16",
                    "--storage-dtype", "float32", "--fusion-mode", "brickmajor"],
              tmp_path, "cfg", monkeypatch)
    f = got.recon.config.fusion
    assert got.rc == 0
    assert (f.brick_cap, f.brick_cap_free, f.color_every, f.max_weight, f.distance,
            f.pixel_share, f.share_safe_classify, f.weight_dtype, f.storage_dtype) == (
        512, 300, 3, None, "point_to_point", 4, False, "bfloat16", "float32")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


MULTI_DEVICE_ARGS = {
    # --distributed alone: a one-rank group on this device (Gloo on the CPU)
    "distributed": (["--distributed"], 1, "brickmajor"),
    # packed, refused on one device, runs under a mesh as sharded bricked
    "distributed_packed": (["--distributed", "--fusion-mode", "packed"], 1, "bricked"),
    # a one-rank group over a TCP store at the coordinator
    "multihost_coordinator": (["--multihost", "--coordinator", "localhost:{port}",
                               "--num-processes", "1", "--process-id", "0",
                               "--distributed"], 1, "brickmajor"),
    # --multihost without --distributed: the group, but no mesh
    "multihost_no_mesh": (["--multihost", "--coordinator", "localhost:{port}",
                           "--num-processes", "1", "--process-id", "0"], 0, "brickmajor"),
    # as in the JAX CLI, the group's flags mean nothing without --multihost
    "group_flags_alone": (["--num-processes", "2", "--process-id", "1", "--coordinator",
                           "localhost:1"], 0, "brickmajor"),
}


@pytest.mark.parametrize("case", sorted(MULTI_DEVICE_ARGS))
def test_multi_device_flags_run(case, sequence, tmp_path, monkeypatch):  # noqa: F811
    """The multi-device flags run the pipeline: a one-rank mesh (``ranks``
    1, the fusion mode it runs) or, where the JAX CLI makes no mesh, the
    single-device path; the process group is gone afterwards."""
    import torch.distributed as dist

    root, stats = sequence
    extra, ranks, mode = MULTI_DEVICE_ARGS[case]
    port = str(_free_port())
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval",
                    "--frames", "3"] + [a.replace("{port}", port) for a in extra],
              tmp_path, case, monkeypatch)
    assert got.rc == 0 and got.summary["frames"] == 3 and got.summary["ate_pairs"] == 3
    assert got.summary["ate_rmse_m"] < 0.05, got.summary
    assert got.summary.get("ranks", 0.0) == ranks
    assert (got.recon.mesh is not None) == bool(ranks)
    assert got.recon.config.fusion.mode == mode
    assert not dist.is_initialized()


@pytest.mark.parametrize("extra,message", [
    (["--coordinator", "localhost:1"], "Number of processes must be defined"),
    (["--coordinator", "localhost:1", "--num-processes", "2"], "process id"),
    ([], "coordinator_address should be defined"),
], ids=["no_num_processes", "no_process_id", "no_coordinator_no_env"])
def test_multihost_bad_combinations_raise_as_jax(extra, message, tmp_path, monkeypatch):
    """--multihost with an incomplete group raises ValueError before any
    work, as jax.distributed.initialize does under the JAX CLI."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match=message):
        cli.main(["--synthetic", "--cpu", "--multihost", "--trajectory",
                  str(tmp_path / "t.txt")] + extra)
    assert not (tmp_path / "t.txt").exists()


def test_preset_synthetic64_runs(tmp_path, capsys):
    """The JAX README's first command, shortened to 3 frames: the synthetic64
    preset as it is (dense fusion, the full 2-D filter) runs and meshes."""
    ply, traj = tmp_path / "scene.ply", tmp_path / "t.txt"
    rc = cli.main(["--preset", "synthetic64", "--synthetic", "--frames", "3", "--mesh",
                   str(ply), "--eval", "--json", "--cpu", "--trajectory", str(traj)])
    out = capsys.readouterr()
    assert rc == 0, out.err
    s = json.loads(out.out.strip().splitlines()[-1])
    assert s["frames"] == 3 and s["ate_pairs"] == 3 and s["ate_rmse_m"] < 0.01
    assert ply.read_bytes().startswith(b"ply\n") and "mesh:" in out.err


def test_preset_with_unported_mode_exits_2(tmp_path, monkeypatch, capsys):
    """A preset whose modes the port does not run together (the central
    Jacobian under a mesh, which the JAX package's sharded tracker refuses
    too) exits 2 with one line that names the mode, and no traceback."""
    from tracking_sdf_tpu_torch import config

    base = config.preset("synthetic64")
    monkeypatch.setattr(config, "preset", lambda name: dataclasses.replace(
        base, tracking=base.tracking._replace(jacobian="central")))
    traj = tmp_path / "t.txt"
    rc = cli.main(["--synthetic", "--frames", "2", "--cpu", "--distributed",
                   "--trajectory", str(traj)])
    err = capsys.readouterr().err.strip()
    assert rc == 2 and len(err.splitlines()) == 1
    assert "central" in err and "not ported" in err and "Traceback" not in err
    assert not traj.exists()


def test_parser_has_every_jax_flag():
    """Every option of the JAX CLI exists under the same name, takes as many
    arguments and has the same default and choices."""
    def options(parser):
        return {s: a for a in parser._actions for s in a.option_strings}

    ours, theirs = options(cli.build_parser()), options(jcli.build_parser())
    assert set(theirs) <= set(ours), sorted(set(theirs) - set(ours))
    assert set(ours) - set(theirs) == set()
    for name, a in theirs.items():
        b = ours[name]
        assert (b.dest, b.nargs, b.default, b.type, b.choices, b.const) == (
            a.dest, a.nargs, a.default, a.type, a.choices, a.const), name


def test_no_gpu_and_no_cpu_flag_is_an_error(sequence, tmp_path, capsys):  # noqa: F811
    """Without ``--cpu`` and without a GPU the CLI exits non-zero and runs
    nothing: it never carries on on the CPU by itself."""
    assert not torch.cuda.is_available()
    root, _ = sequence
    traj = tmp_path / "t.txt"
    rc = cli.main(["--dataset", root, "--trajectory", str(traj)])
    assert rc not in (0, 2) and "--cpu" in capsys.readouterr().err and not traj.exists()
    assert cli.main(["--cpu"]) == 2  # neither --dataset nor --synthetic


def test_native_loader_flag_raises_when_it_cannot_be_built(sequence, tmp_path,  # noqa: F811
                                                           monkeypatch):
    root, stats = sequence
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", native.NativeLoaderError("no compiler here"))
    with pytest.raises(native.NativeLoaderError, match="no compiler here"):
        cli.main(["--dataset", root, "--camera", camera_arg(stats), "--cpu",
                  "--native-loader", "--trajectory", str(tmp_path / "t.txt")])


def test_camera_argument():
    assert cli._parse_camera(None) == cli._parse_camera("fr1")
    assert cli._parse_camera("kinect").fx == 525.0
    cam = cli._parse_camera("100,101,50,40,160,120")
    assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height) == (
        100.0, 101.0, 50.0, 40.0, 160, 120)
    assert cli._parse_camera("100,101,50,40").width == 640
    with pytest.raises(SystemExit):
        cli._parse_camera("1,2,3")


def test_profiling_helpers(tmp_path):
    timer = Timer()
    with timer("a"):
        pass
    with device_timer(timer, "b", "cpu"):
        torch.ones(4).sum()
    with device_timer(timer, "b", torch.device("cpu")):
        pass
    assert timer.counts == {"a": 1, "b": 2} and timer.mean_ms("b") >= 0.0
    assert timer.mean_ms("missing") == 0.0
    assert timer.report().splitlines()[1].startswith("b: ")
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 100
    assert len(prof.key_averages()) > 0
