"""One run of one cell: set-up, the measured window, the check.

Set-up: the kernel library is loaded (built by nvcc into the port's fixed
build/torch_kernels/ inside the checkout on a checkout's first run), the
traffic's frames are generated and staged on the device from the seed, one
``Reconstruction`` is built, frame 0 bootstraps it through
``process_frame``, and chunks are run until every graph variant is captured
and every calibration key of the chunk step is met (color on and off, each
``(frame + 1) % color_every`` phase), then two more.

The window: ``Reconstruction.process_chunk`` on the traffic's chunks,
closed loop, for ``seconds``, in sessions of the traffic's
``session_frames`` frames, as a user records one sequence after another:
at each session's start the program's state after the bootstrap frame
(its rows, pose, velocity carry and frame count) is put back, so that every
session does the same work whatever the program's speed. The restart is
part of the window's wall time. Inside it, in a session reached at a time
drawn from the seed and at a chunk of the session drawn from it, the
program's rows and pose are copied before and after a run of
``SAMPLE_CHUNKS`` chunks (the copies are device-to-device into buffers made
in set-up, outside every chunk's timing); with ``trace`` the profiler
records ``TRACE_GROUPS`` groups of ``TRACE_CHUNKS`` chunks of one session
each, spread over the window.

After it: the peak device memory is read, the program's state is freed,
and the plain reference decides ``correct`` (harness.check).
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from harness import bounds, check, data, trace as tr, traffic as gen
from reference.lie import Pose as RPose

SAMPLE_CHUNKS = 2
TRACE_GROUPS = 4
TRACE_CHUNKS = 4
WARM_EXTRA = 2


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts(fs) -> Optional[list]:
    """A frame's FuseStats in the reference's order of counts."""
    if fs is None:
        return None
    return [fs.n_full, fs.n_free, fs.overflow_active, fs.overflow_mixed, fs.overflow]


class Window:
    """What the window's chunks returned."""

    def __init__(self):
        self.walls: List[float] = []
        self.frames = 0  # handed to process_chunk
        self.rejected = 0
        self.iterations: List[int] = []
        self.ends: List[float] = []
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None

    def add(self, t0: float, t1: float, stats) -> None:
        self.t_first = t0 if self.t_first is None else self.t_first
        self.t_last = t1
        self.walls.append(t1 - t0)
        self.ends.append(t1)
        self.frames += len(stats)
        self.rejected += sum(s.rejected for s in stats)
        self.iterations += [s.gn_iterations for s in stats]

    @property
    def seconds(self) -> float:
        return (self.t_last - self.t_first) if self.walls else 0.0

    def quarters(self) -> List[tuple]:
        """(frames/s, chunk ms median, chunk ms p95) of each quarter of the window."""
        out = []
        ends, walls = np.array(self.ends), np.array(self.walls) * 1e3
        per = len(self.ends) and self.frames / len(self.ends)
        for q in range(4):
            a = self.t_first + self.seconds * q / 4
            b = self.t_first + self.seconds * (q + 1) / 4
            sel = (ends > a) & (ends <= b)
            if sel.any():
                out.append((round(float(per * sel.sum() / (b - a)), 1), round(float(np.median(walls[sel])), 3),
                            round(float(np.percentile(walls[sel], 95)), 3)))
        return out


def end_to_end(win: Window, setup_s: float) -> dict:
    """The end-to-end metrics: the frames whose records came back, less
    those the failure gate rejected, over the window's wall time (first
    hand-off to last return), the 95th percentile of every chunk's wall
    time (linear between order statistics), set-up."""
    return {"frames_per_s": dict(value=(win.frames - win.rejected) / win.seconds,
                                 unit="frames/s"),
            "chunk_ms_p95": dict(value=float(np.percentile(np.array(win.walls) * 1e3, 95)),
                                 unit="ms"),
            "setup_s": dict(value=setup_s, unit="s")}


def run(cfg: dict, traffic: dict, limits: dict, seed: int, seconds: float, trace: bool,
        metrics: Dict[str, Callable], device: str = "cuda",
        t_start: Optional[float] = None, controls: Sequence[str] = ()) -> dict:
    """One run. ``metrics``: the per-layer readers to report with ``trace``;
    ``controls``: storage precisions in which the reference is also put in
    the program's place (perfbench/control.py; never in a benchmark run).
    Returns the result line's dict (its last key ``limits``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    fd, traj = tempfile.mkstemp(prefix="perfbench-trajectory-", suffix=".txt")
    os.close(fd)
    try:
        with warnings.catch_warnings():
            # tum512's FREE cap binds every frame: the count is in each frame's record
            warnings.filterwarnings("ignore", message="process_chunk: .* brick-cap overflow",
                                    category=RuntimeWarning)
            return _run(cfg, traffic, limits, seed, seconds, trace, metrics,
                        torch.device(device), t_start, traj, controls)
    finally:
        os.unlink(traj)


def _run(cfg, traffic, limits, seed, seconds, trace, metrics, dev, t_start, traj,
         controls) -> dict:
    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.core.lie import Pose as PPose
    from tracking_sdf_tpu_torch.pipeline import chunk as pchunk
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    setup = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if dev.type == "cuda":
        from tracking_sdf_tpu_torch.kernels import _build

        _build.library()
    setup["library_s"] = time.perf_counter() - t
    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    seq = gen.generate(traffic, cfg["camera"], seed, dev, traffic["chunk"])
    _sync(dev)
    setup["generate_s"] = time.perf_counter() - t
    cam = PinholeCamera(**cfg["camera"])
    chunk = traffic["chunk"]
    ce = cfg["fusion"]["color_every"]
    p0 = gen.pose0()
    t = time.perf_counter()
    recon = Reconstruction(cam, data.pipeline_config(cfg, traj),
                           initial_pose=PPose(p0.R.clone(), p0.t.clone()), device=dev)
    recon.process_frame(seq.depth[0], seq.rgb[0])
    bg = recon.brick_grid
    nz = torch.nonzero((bg.W > 0).any(1)).reshape(-1)
    start_rows = (nz, bg.D[nz].clone(), bg.W[nz].clone(), bg.C[nz].clone())
    # the state a session starts from: the program's after the bootstrap frame
    # (with the saturated-FREE bitset of a configuration that keeps one)
    sat = getattr(recon, "_sat", None)
    boot = ((bg.D.clone(), bg.W.clone(), bg.C.clone()), recon.pose.R.clone(),
            recon.pose.t.clone(), recon._pose_prev, recon.frame_num,
            None if sat is None else sat.clone())
    session = traffic["session_frames"]
    if session % chunk or session < SAMPLE_CHUNKS * chunk:
        raise ValueError(f"session_frames {session}: a whole number of chunks of {chunk}, "
                         f"at least {SAMPLE_CHUNKS}")
    stamps = [float(recon.frame_num)]  # the last trajectory timestamp handed out

    def restart():
        (D, W, C), R, tt, prev, num, sat0 = boot
        for dst, src in zip((bg.D, bg.W, bg.C), (D, W, C)):
            dst.copy_(src)
        if sat0 is not None:
            sat.copy_(sat0)
        recon.pose = PPose(R.clone(), tt.clone())
        recon._pose_prev = prev
        recon.frame_num = num

    def position() -> int:
        """The chunk of the session that the next chunk is."""
        return (recon.frame_num - boot[4]) // chunk

    def next_chunk():
        # position j holds frame j + 1; the timestamps run on over the sessions
        d, c = seq.chunk(recon.frame_num, chunk)
        ts = [stamps[0] + 1 + k for k in range(chunk)]
        stamps[0] = ts[-1]
        return recon.process_chunk(d, c, timestamps=ts)

    phases = {(recon.frame_num + 1 + k * chunk) % max(ce, 1) for k in range(max(ce, 1))}
    for _ in range(len(phases) + WARM_EXTRA):
        next_chunk()
    if trace:  # the profiler's first start (CUPTI's set-up) belongs to set-up
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            next_chunk()
    snaps = [tuple(torch.empty_like(x) for x in (bg.D, bg.W, bg.C)) for _ in range(2)]
    restart()  # the window starts a session
    _sync(dev)
    setup["reconstruction_s"] = time.perf_counter() - t
    steps = recon._chunk_steps
    setup["capture_ms"] = sorted(steps.capture_ms.values()) if steps else []
    setup["calibration_ms"] = list(steps.calibration_ms) if steps else []

    win = Window()
    sample_at = seconds * rng.uniform(0.25, 0.75)
    sample_pos = int(rng.integers(0, session // chunk - SAMPLE_CHUNKS + 1))
    sessions = 1
    trace_at = [seconds * (g + 0.5) / TRACE_GROUPS for g in range(TRACE_GROUPS)] if trace else []
    sample = None
    groups, traced = [], dict(frames=[], counts=[], colors=[], launches=0)
    lc0 = pchunk.launch_counts()
    t_window = time.perf_counter()
    setup_s = t_window - t_start

    def timed():
        a = time.perf_counter()
        stats = next_chunk()
        win.add(a, time.perf_counter(), stats)
        return stats

    def take_sample():
        D, W, C = recon.brick_grid.D, recon.brick_grid.W, recon.brick_grid.C
        for dst, src in zip(snaps[0], (D, W, C)):
            dst.copy_(src)
        pose = RPose(recon.pose.R.clone(), recon.pose.t.clone())
        frame_num, first = recon.frame_num, stamps[0] + 1
        _sync(dev)
        j = frame_num  # the traversal position of the sample's first frame
        rejected, counts, iters = [], [], []
        for _ in range(SAMPLE_CHUNKS):
            stats = timed()
            rejected += [s.rejected for s in stats]
            iters += [s.gn_iterations for s in stats]
            counts += [_counts(fs) for fs in recon.chunk_fuse_stats]
        for dst, src in zip(snaps[1], (D, W, C)):
            dst.copy_(src)
        _sync(dev)
        ins = [seq.chunk(j + k * chunk, chunk) for k in range(SAMPLE_CHUNKS)]
        return check.Sample(snaps[0], pose, frame_num, torch.cat([d for d, _ in ins]),
                            torch.cat([c for _, c in ins]), snaps[1], rejected, counts, iters,
                            first_stamp=first)

    def traced_group():
        from torch.profiler import ProfilerActivity, profile, record_function

        lc = sum(pchunk.launch_counts())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_CHUNKS):
                first = recon.frame_num + 1
                with record_function(tr.CHUNK_SPAN):
                    stats = timed()
                traced["frames"] += [(s.gn_iterations, s.num_valid) for s in stats]
                traced["counts"] += [_counts(fs) for fs in recon.chunk_fuse_stats]
                traced["colors"] += [ce <= 1 or (first + k) % ce == 0 for k in range(len(stats))]
        traced["launches"] += sum(pchunk.launch_counts()) - lc
        groups.append(prof)  # its events are read once the window has closed

    while True:
        now = time.perf_counter() - t_window
        if now >= seconds:
            break
        pos = position()
        if pos * chunk >= session:
            restart()
            sessions += 1
        elif sample is None and now >= sample_at and pos == sample_pos:
            sample = take_sample()
        elif trace_at and now >= trace_at[0] and pos * chunk + TRACE_CHUNKS * chunk <= session:
            trace_at.pop(0)
            traced_group()
        else:
            timed()
    launches = [b - a for a, b in zip(lc0, pchunk.launch_counts())]
    while sample is None:  # a window too short to reach it: the check follows it
        pos = position()
        if pos * chunk >= session:
            restart()
        elif pos == sample_pos:
            sample = take_sample()
        else:
            timed()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    recon.close()
    poses = check.read_trajectory(traj, sample.frames)
    del recon, steps, bg
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- the check
    t = time.perf_counter()
    store = cfg["fusion"]["storage_dtype"]
    pose0 = RPose(p0.R.to(dev), p0.t.to(dev))
    ref_start = check.start_leaves(cfg, pose0, seq.depth[0], seq.rgb[0], store, dev)
    numbers = check.compare_start(cfg, start_rows, ref_start)
    ref_out = check.reference_outputs(cfg, sample, store)
    numbers.update(check.compare(check.program_outputs(sample, poses), ref_out, sample.frames))
    check_s = time.perf_counter() - t
    correct = check.judge(numbers, limits)
    controls_out = {}
    for cs in controls:  # the reference in a lower precision in the program's place
        c_start = check.start_leaves(cfg, pose0, seq.depth[0], seq.rgb[0], cs, dev)
        rows = torch.nonzero((c_start["W"] > 0).any(1) | (ref_start["W"] > 0).any(1)).reshape(-1)
        d, w, _ = check.grid_gaps({k: v[rows] for k, v in c_start.items()},
                                  {k: v[rows] for k, v in ref_start.items()}, None)
        cn = dict(start_d_mm=d * 1e3, start_w=w)
        cn.update(check.compare(check.reference_outputs(cfg, sample, cs), ref_out, sample.frames))
        controls_out[cs] = cn

    # --- the metrics
    pk = bounds.peaks(kind)
    out_metrics = {}
    dev_out = dict(platform="gpu" if dev.type == "cuda" else dev.type, kind=kind, count=1,
                   memory_peak_bytes=int(peak))
    breakdown = None
    if not trace:
        out_metrics = end_to_end(win, setup_s)
    else:
        patterns = data.layer_patterns()
        red = tr.reduce([tr.simplify(p.events()) for p in groups], patterns)
        ctx = dict(cfg=cfg, window=win, launches=launches, trace=red, traced=traced, peaks=pk,
                   hw=(cam.height, cam.width), bounds=bounds)
        for name, (read, unit) in metrics.items():
            v = read(ctx)
            if v is not None:
                out_metrics[name] = dict(value=float(v), unit=unit)
        dev_out.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = tr.breakdown(red)
        n_prof = sum(n for k, n in red["kernel_n"].items()
                     if data.layer_of(k, patterns) != "other")
        log(f"profiler: {n_prof} hand-written kernel launches seen, the counters "
            f"{traced['launches']} over the {len(traced['frames'])} profiled frames; "
            f"{sum(red['kernel_n'].values())} device ops in all")
        other = {k: v for k, v in red["kernel_s"].items() if data.layer_of(k, patterns) == "other"}
        log("other (no layer): " + "; ".join(f"{k[:90]} {v:.6f} s" for k, v in
                                               sorted(other.items(), key=lambda kv: -kv[1])))
    log(f"set-up: {setup_s:.3f} s (interpreter, torch and the harness {setup['start_s']:.3f}, "
        f"library {setup['library_s']:.3f}, generate "
        f"{setup['generate_s']:.3f}, reconstruction and warm-up "
        f"{setup['reconstruction_s']:.3f}; capture ms {setup['capture_ms']}, calibration ms "
        f"{setup['calibration_ms']})")
    R = sample.pose.R.double()
    ortho = float((R.T @ R - torch.eye(3, dtype=R.dtype, device=R.device)).abs().max())
    log(f"window: {win.frames} frames in {len(win.walls)} chunks and {sessions} sessions over "
        f"{win.seconds:.3f} s, "
        f"{win.rejected} rejected, GN iterations a frame {np.mean(win.iterations):.3f}; by "
        f"quarter (frames/s, chunk ms median, p95) {win.quarters()}; "
        f"peak {peak} B; check {check_s:.3f} s over frames {sample.frames[0]}-"
        f"{sample.frames[-1]}: fusion counts equal on {numbers['counts_equal']} of "
        f"{numbers['frames']} frames from session frame {sample.frame_num + 1}, the program's "
        f"|R^T R - I| {ortho!r}; frames "
        f"that differ (frame, mm, mdeg, GN iterations program / reference, counts equal): "
        f"{numbers['differ']}")
    shown = {k: dict(value=float(numbers[k]), limit=float(limits[k])) for k in limits}
    for k, v in shown.items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    res = dict(correct=bool(correct), attempted=win.frames, failed=win.rejected,
               metrics=out_metrics, device=dev_out)
    if breakdown is not None:
        res["breakdown"] = breakdown
    if controls_out:
        res["controls"] = controls_out
    res["limits"] = shown
    return res
