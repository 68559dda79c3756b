"""The port's mesh publisher, run(mesh_every=), Reconstruction.render and the
CLI's mesh and render flags, on the CPU.

Sizes: the chunk tests' tum256 at m=48 over their sphere, box and wall
(tests/test_torch_chunk.py), and the CLI tests' 8 generated frames at
160x120 with the m=96 configuration (tests/test_torch_cli.py). The
publisher cases follow the JAX package's (tests/test_pyramid_checkpoint.py:
publish, degrade with a warning, a decimated live mesh coarser than the
final one). Exact checks: the export indices of run(mesh_every=), equal
files where the grid is the same, and the ATE of a CLI run with the mesh
and render flags equal to the digit to one without them.
"""
import dataclasses
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from test_torch_chunk import chunk_config, make_frames, new_recon
from test_torch_cli import Run, camera_arg, sequence  # noqa: F401 (a fixture)
from tracking_sdf_tpu_torch import cli
from tracking_sdf_tpu_torch.config import RaycastConfig
from tracking_sdf_tpu_torch.data.tum import TUMFrame, decode_png
from tracking_sdf_tpu_torch.pipeline import chunk as chunked
from tracking_sdf_tpu_torch.pipeline import runner
from tracking_sdf_tpu_torch.pipeline.visualizer import MeshPublisher

torch.set_num_threads(2)


def _ply_header(path):
    with open(path, "rb") as f:
        head = f.read(400).partition(b"end_header\n")[0].decode()
    faces = int(head.split("element face ")[1].split()[0])
    return head, faces


def _wait(cond, timeout=20.0):
    t0 = time.perf_counter()
    while not cond() and time.perf_counter() - t0 < timeout:
        time.sleep(0.02)
    return cond()


# --- the publisher ---------------------------------------------------------------

def test_publisher_exports_during_the_loop_and_on_close(tmp_path):
    depths, rgbs = make_frames(3)
    r = new_recon(chunk_config("tum256", 48))
    path = str(tmp_path / "live.ply")
    pub = r.start_mesh_publisher(path, with_colors=False)
    for i, d in enumerate(depths):
        r.process_frame(d, rgbs[i], timestamp=float(i))
        time.sleep(0.05)
    r.close()  # stops the thread, then the final export
    assert r._publisher is None
    assert pub.published >= 1 and pub.errors == 0, pub.last_error
    head, faces = _ply_header(path)
    assert faces > 100 and "red" not in head


def test_publisher_rate_degrades_with_a_warning():
    """An export of 0.25 s against a 0.05 s interval stretches the interval,
    reported by degraded_cycles and one warning."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pub = MeshPublisher(lambda snap: time.sleep(0.25), interval=0.05)
        pub.publish({"x": torch.zeros(())})
        time.sleep(0.8)
        pub.close(final=False)
    assert pub.degraded_cycles >= 1 and pub.effective_interval > 0.2
    assert sum("instead" in str(w.message) for w in rec) == 1


def test_publisher_decimated_live_mesh_is_coarser(tmp_path):
    """mesh_decimate=2: the live mesh is meshed on every 2nd voxel; the final
    export_mesh is not decimated."""
    depths, rgbs = make_frames(2)
    cfg = dataclasses.replace(chunk_config("tum256", 48), mesh_decimate=2, mesh_hz=20.0)
    r = new_recon(cfg)
    live, final = str(tmp_path / "live.ply"), str(tmp_path / "final.ply")
    pub = r.start_mesh_publisher(live, with_colors=False)
    for i, d in enumerate(depths):
        r.process_frame(d, rgbs[i], timestamp=float(i))
        time.sleep(0.1)
    n_full = r.export_mesh(final, with_colors=False)
    r.close()
    assert pub.errors == 0 and pub.published >= 1, pub.last_error
    _, n_live = _ply_header(live)
    assert 0 < n_live < n_full / 2


def test_publisher_reports_errors_and_copies_the_snapshot():
    """An export that raises is counted and kept in last_error (the thread
    goes on); the snapshot is a copy, so later in-place updates of the
    published tensors do not reach it."""
    seen = []

    def export(snap):
        seen.append(float(snap["D"].sum()))
        raise OSError("disk full")

    pub = MeshPublisher(export, interval=0.05)
    D = torch.ones(4)
    pub.publish({"D": D})
    D.fill_(7.0)
    assert _wait(lambda: pub.errors >= 2)
    pub.close(final=True)
    assert pub.published == 0 and isinstance(pub.last_error, OSError)
    assert set(seen) == {4.0}


def test_publisher_export_holds_the_device_lock(tmp_path):
    """The runner's export waits while the device lock is held (as a
    CUDA-graph capture and a chunk's replays hold it), and runs once it is
    released."""
    depths, rgbs = make_frames(1)
    r = new_recon(chunk_config("tum256", 48))
    path = str(tmp_path / "live.ply")
    with chunked.DEVICE_LOCK:
        pub = r.start_mesh_publisher(path, with_colors=False)
        r.process_frame(depths[0], rgbs[0], timestamp=0.0)
        time.sleep(0.3)
        assert pub.published == 0 and not os.path.exists(path)
    assert _wait(lambda: pub.published >= 1)
    r.close()
    assert pub.errors == 0 and os.path.getsize(path) > 500


def test_device_lock_is_reentrant_and_shared():
    assert isinstance(chunked.DEVICE_LOCK, type(threading.RLock()))
    with chunked.DEVICE_LOCK, chunked.DEVICE_LOCK:
        pass


# --- run(mesh_every=) and render ----------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 3], ids=["per_frame", "chunk3"])
def test_run_mesh_every(tmp_path, chunk):
    """mesh_every=2 over 7 frames exports at indices 2, 4 and 6, also when a
    chunk emits them (after the chunk ran, with its final grid); the chunked
    run's last export is the final grid's mesh, file for file."""
    depths, rgbs = make_frames(7)
    frames = [TUMFrame(timestamp=float(i), depth=d, rgb=c)
              for i, (d, c) in enumerate(zip(depths, rgbs))]
    r = new_recon(chunk_config("tum256", 48))
    path = str(tmp_path / "m.ply")
    calls = []
    export = r.export_mesh
    r.export_mesh = lambda p, **k: calls.append((r.frame_num, p)) or export(p, **k)
    r.run(frames, mesh_every=2, mesh_path=path, chunk=chunk)
    r.close()
    want = [(2, path), (4, path), (6, path)] if not chunk else [(4, path), (4, path), (7, path)]
    assert calls == want
    assert _ply_header(path)[1] > 100
    if chunk:
        again = str(tmp_path / "again.ply")
        export(again)
        with open(path, "rb") as f, open(again, "rb") as g:
            assert f.read() == g.read()


def test_run_mesh_path_alone_exports_nothing(tmp_path):
    depths, rgbs = make_frames(2)
    r = new_recon(chunk_config("tum256", 48))
    r.run([TUMFrame(float(i), d, c) for i, (d, c) in enumerate(zip(depths, rgbs))],
          mesh_path=str(tmp_path / "m.ply"))
    r.close()
    assert not os.path.exists(tmp_path / "m.ply") and r.frame_num == 2


def test_render_of_the_runner(tmp_path):
    """Reconstruction.render: the dense view from the current pose, warm
    start from a previous range, and a RuntimeWarning when rays drop."""
    depths, rgbs = make_frames(2)
    r = new_recon(chunk_config("tum256", 48))
    for i, d in enumerate(depths):
        r.process_frame(d, rgbs[i], timestamp=float(i))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cold = r.render(stride=2)
        warm = r.render(stride=2, t_init=cold.range_t)
    assert cold.hit.float().mean() > 0.1 and int(cold.dropped) == 0
    assert cold.rgb is not None and (warm.hit == cold.hit).float().mean() > 0.99
    r.config = dataclasses.replace(r.config, raycast=RaycastConfig(
        sample="trilinear", two_phase="on", step_scale=0.1, max_steps=30))
    with pytest.warns(RuntimeWarning, match="recovery capacity"):
        res = r.render(with_color=False)
    assert int(res.dropped) > 0 and res.rgb is None
    r.close()


# --- the CLI ------------------------------------------------------------------------

def test_cli_mesh_render_and_mesh_async(sequence, tmp_path, monkeypatch):  # noqa: F811
    """--chunk 3 with --mesh, --render and --mesh-async: the files exist, the
    PLY header parses, the port's decoder reads the panel image, the
    publisher exported without error, and the ATE equals the run without
    the flags."""
    root, stats = sequence
    pubs = []
    start = runner.Reconstruction.start_mesh_publisher

    def recording(self, *a, **k):
        pubs.append(start(self, *a, **k))
        return pubs[-1]

    monkeypatch.setattr(runner.Reconstruction, "start_mesh_publisher", recording)
    base = ["--dataset", root, "--camera", camera_arg(stats), "--eval", "--chunk", "3"]
    mesh, png, live = (str(tmp_path / n) for n in ("m.ply", "r.png", "live.ply"))
    got = Run(cli, base + ["--mesh", mesh, "--render", png, "--mesh-async", live,
                           "--mesh-hz", "50"], tmp_path, "flags", monkeypatch)
    plain = Run(cli, base, tmp_path, "plain", monkeypatch)
    assert got.rc == plain.rc == 0
    n_tri = _ply_header(mesh)[1]
    assert f"mesh: {n_tri} triangles -> {mesh}" in got.stderr and n_tri > 1000
    assert f"render -> {png}" in got.stderr
    head, _ = _ply_header(live)
    assert "red" in head
    data, channels, bit_depth = decode_png(png)
    assert data.shape == (120, 3 * 160, 3) and (channels, bit_depth) == (3, 8)
    assert len(pubs) == 1 and pubs[0].published >= 1 and pubs[0].errors == 0
    assert got.summary["ate_rmse_m"] == plain.summary["ate_rmse_m"] < 0.05
    with open(got.trajectory) as a, open(plain.trajectory) as b:
        assert a.read() == b.read()


def test_cli_mesh_every_and_no_color_render(sequence, tmp_path, monkeypatch):  # noqa: F811
    """--mesh-every 4 exports during the run, --no-color renders two panels;
    the final --mesh export keeps vertex colors (grey here), as the JAX
    CLI's does."""
    root, stats = sequence
    mesh, png = str(tmp_path / "m.ply"), str(tmp_path / "r.png")
    exports = []
    export = runner.Reconstruction.export_mesh
    monkeypatch.setattr(runner.Reconstruction, "export_mesh",
                        lambda self, p, **k: exports.append(self.frame_num) or export(self, p, **k))
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--no-color",
                    "--mesh", mesh, "--mesh-every", "4", "--render", png], tmp_path, "nc",
              monkeypatch)
    assert got.rc == 0 and exports == [4, 8, 8]
    assert "red" in _ply_header(mesh)[0]
    assert decode_png(png)[0].shape == (120, 2 * 160, 3)


MESH_FLAGS = {"mesh": ["--mesh", "m.ply"], "mesh_every": ["--mesh-every", "5"],
              "mesh_async": ["--mesh-async", "a.ply"], "mesh_hz": ["--mesh-hz", "2"],
              "mesh_decimate": ["--mesh-decimate", "2"], "render": ["--render", "r.png"]}


@pytest.mark.parametrize("flag", sorted(MESH_FLAGS))
def test_mesh_and_render_flags_are_ported(flag):
    """These flags no longer exit 2: they parse to a value other than their
    default, and the CLI keeps no list of refused flags."""
    parser = cli.build_parser()
    args = parser.parse_args(["--dataset", "d"] + MESH_FLAGS[flag])
    assert getattr(args, flag) != parser.get_default(flag)
    assert not hasattr(cli, "UNPORTED") and not hasattr(cli, "_unported")
