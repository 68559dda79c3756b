"""Chunked processing: many frames per host round trip (counterpart of the
chunk functions of tracking_sdf_tpu.pipeline.runner, ``_chunk_fn`` and
``_chunk_calibrate``, single device).

The JAX package runs a chunk as one jitted ``lax.fori_loop``. Here one frame
is a step on device buffers that persist from frame to frame, in the order
of the JAX package's ``frame_step``: the optional TUM uint16 decode,
preprocess, the constant-velocity guess chosen on the device by
``have_prev``, tracking (``cfg.max_iterations`` K1 launches per level,
``gn_step`` or with the central Jacobian K1's central form on the D and W
rows; no read), the failure gate on the device, NaN points and normals on a rejected
frame (fusion of an all-NaN frame leaves the rows bitwise unchanged), fusion
at the chunk's cap (one K2 launch) and the frame's record. On the card each
variant of the step (color on or off) is captured once as a CUDA graph and
a frame is one replay: the host issues a chunk's replays and reads the
records once, and nothing in between waits on the device. On the CPU the
same step runs eagerly (the plain version).

Graph rules kept here: every variant is warmed up eagerly before its
capture, so nothing copies from the host inside it (``fusion.brick``'s
device constants, the kernel library); the inputs, the carry and the record
are buffers allocated outside the graphs, filled by device copies; what the
graphs allocate lives in one pool that the variants share, and nothing of it
outlives a replay. The graphs hold the addresses of the grid's rows, so a
new grid needs a new ``ChunkSteps``.

Device lock: a capture (warm-up included) and a chunk's replays (under the
no-sync guard, which is process-wide) hold ``DEVICE_LOCK``; other threads
that work on the card (the runner's mesh publisher) take it around their
device work, so nothing of theirs runs inside a capture or trips the guard.

Launch counts: a replay runs kernels without calling their wrappers, so a
capture records the launches of one step and each replay adds them to the
wrappers' counters. The warm-up, the capture itself and the calibration
loops are not frames and add nothing.

Tracing (utils.profiling.tracing_enabled, read once a chunk like the
--debug-nans switch) selects the traced variant of each step, captured on
its own: it stamps the device's clock at the step's first and last
operation and widens the frame's record with each pyramid level's full GN
steps (``traced_layout``), read in the same per-frame copy and host read
(``chunk_trace``). The first REC slots, the carry and the rows are the
untraced step's bit for bit; the stamp kernel is counted by no launch
counter.

Under a mesh (parallel.sharded) the step is the same with the sharded
tracker and fusion: its collectives (the halo's all_gather, an all_reduce a
GN iteration, the counts' all_reduce) run inside it. Under NCCL they are
captured in the graphs with the kernels. Gloo copies CUDA tensors through
the host, which can sit neither in a capture nor under the no-sync guard, so
under Gloo the step runs eagerly, frame by frame; the host still reads the
records once per chunk.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tracking_sdf_tpu_torch.core.lie import Pose, pose_compose, pose_inverse
from tracking_sdf_tpu_torch.fusion import brick_classify, brick_fuse, brick_merge
from tracking_sdf_tpu_torch.fusion.brickmajor import BrickGrid
from tracking_sdf_tpu_torch.tracking import gn_reduce, preprocess
from tracking_sdf_tpu_torch.tracking.gn_reduce import S_COUNT
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
from tracking_sdf_tpu_torch.utils import debug_nans, profiling

# A frame's record (float32; the counts are exact): R (9), t (3), GN
# iterations, num_valid, mean |residual|, rejected, fusion's six counts
# (fusion.brickmajor.COUNTS), then under --debug-nans the invariants' fault
# code (utils.debug_nans) as the bits of an int32 (0 without the switch).
REC_R, REC_T, REC_ITERS, REC_NVALID, REC_MRES, REC_REJ, REC_COUNTS = 0, 9, 12, 13, 14, 15, 16
REC_FAULT = 22
REC = 23


def traced_layout(levels: int) -> Tuple[int, int]:
    """(the first stamp's slot, the record's width) of the traced record
    of a step that tracks ``levels`` levels: the REC slots, each level's GN
    state slot S_COUNT (int32 bits: its full steps), coarse to fine, then
    on an 8-byte boundary two int64 stamps."""
    end = REC + levels
    stamps = end + end % 2
    return stamps, stamps + 4


@dataclasses.dataclass(frozen=True)
class ChunkTrace:
    """What a traced chunk's records hold besides the frames' own slots
    (CPU tensors, one row a frame)."""
    # (n, 2) int64: the device's clock in ns at each frame step's first and
    # last operation (%globaltimer; on the CPU the host's perf_counter_ns)
    stamps: torch.Tensor
    # (n, levels) int64, coarse to fine: each level's full GN steps
    full_steps: torch.Tensor


def chunk_trace(out: torch.Tensor, levels: int) -> ChunkTrace:
    """The ChunkTrace of a traced chunk's records ``out`` (n, width)."""
    s0, width = traced_layout(levels)
    return ChunkTrace(
        stamps=out[:, s0:width].contiguous().view(torch.int64),
        full_steps=out[:, REC:REC + levels].contiguous().view(torch.int32).to(torch.int64))


# held by a capture and by a chunk's replays; see the module docstring
DEVICE_LOCK = threading.RLock()

# the kernel wrappers' launch counters
_COUNTERS = ((gn_reduce, "launches"), (gn_reduce, "launches_brick"),
             (gn_reduce, "launches_slab"), (gn_reduce, "launches_slab_brick"),
             (gn_reduce, "launches_step"), (gn_reduce, "launches_step_brick"),
             (gn_reduce, "launches_finish"), (gn_reduce, "launches_step_central"),
             (brick_merge, "launches"), (brick_merge, "launches_rows"),
             (brick_fuse, "launches"), (brick_fuse, "launches_sat"),
             (brick_fuse, "launches_slab"), (preprocess, "launches_pass"),
             (preprocess, "launches_2d"), (preprocess, "launches_normals"),
             (brick_classify, "launches_tables"), (brick_classify, "launches_classify"),
             (brick_classify, "launches_compact"))


# the counters' names, "<module>.<counter>", in launch_counts()'s order: a
# reader finds a counter here by name, not by its position
LAUNCH_COUNTERS = tuple(f"{mod.__name__.rsplit('.', 1)[-1]}.{name}" for mod, name in _COUNTERS)


def launch_counts() -> Tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _set_launch_counts(values: Sequence[int]) -> None:
    for (mod, name), v in zip(_COUNTERS, values):
        setattr(mod, name, v)


def velocity_guess(pose: Pose, prev: Pose) -> Pose:
    """The constant-velocity guess T_{n-1} ∘ (T_{n-2}^-1 ∘ T_{n-1})."""
    return pose_compose(pose, pose_compose(pose_inverse(prev), pose))


def decode_tum_depth(bits: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """TUM uint16 depth, held as int16 bits (PyTorch has little uint16
    arithmetic), to float32 meters: d16 / 5000, NaN where d16 == 0. The bits
    are widened on the device; ``scale`` is a 0-dim float32 tensor holding
    5000 on the same device. The card divides a tensor by a Python scalar as
    a product with its reciprocal, but by a tensor as a true division, so
    the result is bitwise numpy's host decode (float32 / 5000)."""
    d16 = (bits.to(torch.int32) & 0xFFFF).to(torch.float32)
    return torch.where(d16 > 0, d16 / scale, float("nan"))


class ChunkSteps:
    """The chunked frame steps of one brick-major Reconstruction and the
    device buffers they share: the carry (pose, previous pose, have_prev),
    each input signature's frame buffers and the frame's record."""

    def __init__(self, recon):
        self.recon = recon
        dev = recon.device
        self.device = dev
        mesh = recon.mesh
        # CUDA graphs on the card, but not under Gloo (module docstring)
        self.graphs = dev.type == "cuda" and (mesh is None or mesh.backend == "nccl")
        f32 = dict(dtype=torch.float32, device=dev)
        self.R, self.t = torch.zeros(3, 3, **f32), torch.zeros(3, **f32)
        self.prev_R, self.prev_t = torch.zeros(3, 3, **f32), torch.zeros(3, **f32)
        self.have_prev = torch.zeros((), dtype=torch.bool, device=dev)
        self.rec = torch.zeros(REC, **f32)
        # the traced record: its tracking levels as Reconstruction._track_levels
        # runs them, and an int64 view of its two stamps
        cfg = recon.config
        self.levels = len(cfg.pyramid_levels) if cfg.pyramid_levels and mesh is None else 1
        s0, width = traced_layout(self.levels)
        self.rec_traced = torch.zeros(width, **f32)
        self._stamps = self.rec_traced[s0:].view(torch.int64)
        self._scale_depth, self._scale_rgb = recon._scale_depth, recon._scale_rgb
        self._inputs: Dict[tuple, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
        self._steps: Dict[tuple, Callable[[], None]] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.capture_ms: Dict[tuple, float] = {}  # per captured variant
        self.debug = False  # the --debug-nans switch of the prepared steps
        self.traced = False  # tracing, for the prepared steps
        self.calibration_ms: List[float] = []  # per calibration

    # --- one frame --------------------------------------------------------

    def _decode_rgb(self, rgb: torch.Tensor) -> torch.Tensor:
        """uint8 colors to [0, 1] as the per-frame path's host decode."""
        return rgb.to(torch.float32) / self._scale_rgb if rgb.dtype == torch.uint8 else rgb

    def _preprocess(self, depth: torch.Tensor):
        """(points, normals) of a float32 or TUM uint16 (int16 bits) frame."""
        cfg = self.recon.config
        if depth.dtype == torch.int16:
            depth = decode_tum_depth(depth, self._scale_depth)
        return preprocess_frame(depth, cam=self.recon.cam, bilateral=cfg.bilateral_filter,
                                bilateral_mode=cfg.bilateral_mode)

    def _frame(self, depth: torch.Tensor, rgb: Optional[torch.Tensor], cap: int,
               debug: bool, traced: bool) -> None:
        """One frame from the input buffers: tracks from the carry, gates,
        fuses, writes the record and advances the carry. ``rgb`` None fuses
        no color; ``debug`` checks the invariants of the rows written and
        the pose into the record; ``traced`` writes the traced record."""
        r = self.recon
        cfg = r.config
        if traced:
            profiling.device_stamp(self._stamps[:1])
        pts, nrm = self._preprocess(depth)
        pose = Pose(self.R, self.t)
        pose0 = pose
        if cfg.pose_init == "velocity":
            pred = velocity_guess(pose, Pose(self.prev_R, self.prev_t))
            pose0 = Pose(torch.where(self.have_prev, pred.R, pose.R),
                         torch.where(self.have_prev, pred.t, pose.t))
        levels = r._track_levels(pose0, pts)
        st = levels[-1].device_stats()
        finite = torch.isfinite(st.pose.R).all() & torch.isfinite(st.pose.t).all()
        rejected = (st.num_valid < cfg.min_valid_pixels) | ~finite
        if cfg.max_mean_residual > 0:
            rejected = rejected | (st.mean_abs_residual > cfg.max_mean_residual)
        new = Pose(torch.where(rejected, pose.R, st.pose.R),
                   torch.where(rejected, pose.t, st.pose.t))
        counts = r._fuse_core(new, torch.where(rejected, float("nan"), pts),
                              torch.where(rejected, float("nan"), nrm),
                              None if rgb is None else self._decode_rgb(rgb), cap,
                              debug=debug)
        scalars = torch.stack([st.iterations.to(torch.float32), st.num_valid,
                               st.mean_abs_residual, rejected.to(torch.float32)])
        n = REC_FAULT - REC_COUNTS
        fault = (counts[n:].to(torch.int32).view(torch.float32) if debug
                 else scalars[:1] * 0)
        parts = [new.R.reshape(9), new.t, scalars, counts[:n].to(torch.float32), fault]
        if traced:
            parts += [lv.state[S_COUNT:S_COUNT + 1] for lv in levels]
            self.rec_traced[:REC + len(levels)].copy_(torch.cat(parts))
        else:
            self.rec.copy_(torch.cat(parts))
        self.prev_R.copy_(self.R)
        self.prev_t.copy_(self.t)
        self.R.copy_(new.R)
        self.t.copy_(new.t)
        self.have_prev.copy_(~rejected)
        if traced:
            profiling.device_stamp(self._stamps[1:])

    # --- capture ----------------------------------------------------------

    def capture(self, fn: Callable[[], None], pool=None):
        """Warm ``fn`` up eagerly on a side stream, then capture it as a
        CUDA graph in ``pool``. Returns (graph, the launch counts of one
        replay); the counters are left as they were."""
        before = launch_counts()
        with DEVICE_LOCK:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn()
            cur.wait_stream(side)
            warm = launch_counts()
            graph = torch.cuda.CUDAGraph()
            # no cyclic GC inside the capture: a collected graph (an older
            # Reconstruction's) would be destroyed in it, which is not
            # permitted while a stream captures and invalidates the capture
            gc_was = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=pool):
                    fn()
            finally:
                if gc_was:
                    gc.enable()
        per_replay = tuple(a - b for a, b in zip(launch_counts(), warm))
        _set_launch_counts(before)
        return graph, per_replay

    def _input(self, hw, depth_dtype, rgb_dtype):
        key = (hw, depth_dtype, rgb_dtype)
        if key not in self._inputs:
            depth = torch.zeros(hw, dtype=depth_dtype, device=self.device)
            rgb = (None if rgb_dtype is None
                   else torch.zeros(hw + (3,), dtype=rgb_dtype, device=self.device))
            self._inputs[key] = (depth, rgb)
        return self._inputs[key]

    def step(self, inp, color_on: bool, cap: int) -> Callable[[], None]:
        """The step of one variant on the input buffers ``inp``: on the card
        a replay of its graph, captured at first use; on the CPU the eager
        step."""
        depth, rgb = inp
        # the sat_skip bitset, when on, is a buffer of the Reconstruction at
        # a fixed address that the graph reads and writes
        key = (tuple(depth.shape), depth.dtype, None if rgb is None else rgb.dtype,
               color_on, cap, self.recon._sat is not None, self.debug, self.traced)
        if key in self._steps:
            return self._steps[key]
        debug, traced = self.debug, self.traced

        def frame():
            self._frame(depth, rgb if color_on else None, cap, debug, traced)

        if not self.graphs:
            self._steps[key] = frame
            return frame
        # the warm-up fuses an all-NaN frame, which leaves the rows as they are
        depth.fill_(0 if depth.dtype == torch.int16 else float("nan"))
        t0 = time.perf_counter()
        with profiling.span("tsdf.chunk.capture"):
            graph, per_replay = self.capture(frame, self._pool)
            torch.cuda.synchronize(self.device)
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3

        def replay():
            graph.replay()
            _set_launch_counts(a + d for a, d in zip(launch_counts(), per_replay))

        self._steps[key] = replay
        return replay

    # --- a chunk ----------------------------------------------------------

    def prepare(self, depths: torch.Tensor, rgbs: Optional[torch.Tensor],
                colors: Sequence[bool], cap: int):
        """The input buffers and the steps (captured now on the card) that
        ``replay`` needs for frames shaped like ``depths`` / ``rgbs``, with
        the --debug-nans switch and tracing as they are now."""
        self.debug = debug_nans.enabled()
        self.traced = profiling.tracing_enabled()
        inp = self._input(tuple(depths.shape[1:3]), depths.dtype,
                          None if rgbs is None else rgbs.dtype)
        return inp, {c: self.step(inp, c, cap) for c in sorted(set(colors))}

    def replay(self, prepared, depths: torch.Tensor, rgbs: Optional[torch.Tensor],
               colors: Sequence[bool], pose: Pose, prev: Optional[Pose]) -> torch.Tensor:
        """Run the frames from the carry (``pose``, ``prev`` or None) and
        read their records once: (n, REC) float32 on the CPU, traced (n,
        ``traced_layout(levels)[1]``). ``depths`` and ``rgbs`` are on the
        device or in pinned host memory; on the card no host sync happens
        between the first replay and the read."""
        (depth, rgb), steps = prepared
        rec = self.rec_traced if self.traced else self.rec
        with profiling.span("tsdf.chunk.issue"):
            self.R.copy_(pose.R)
            self.t.copy_(pose.t)
            p = prev if prev is not None else pose
            self.prev_R.copy_(p.R)
            self.prev_t.copy_(p.t)
            self.have_prev.fill_(prev is not None)
            out = torch.empty((len(colors), rec.shape[0]), dtype=torch.float32,
                              device=self.device)
            # eager steps (the CPU, Gloo) neither capture nor guard: no lock
            with (DEVICE_LOCK if self.graphs else contextlib.nullcontext()), \
                    self._no_host_sync():
                for k, color in enumerate(colors):
                    depth.copy_(depths[k], non_blocking=True)
                    if rgb is not None:
                        rgb.copy_(rgbs[k], non_blocking=True)
                    steps[color]()
                    out[k].copy_(rec)
        with profiling.span("tsdf.chunk.read"):
            return out.cpu()

    @contextlib.contextmanager
    def _no_host_sync(self):
        """On the card, any host sync inside raises."""
        if not self.graphs:
            yield
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    # --- phase calibration ------------------------------------------------

    def _timed_ms(self, fn: Callable[[], None], restore: Callable[[], None]) -> float:
        """Best of two runs of ``fn``, each after ``restore()``: on the card
        replays of its graph (captured in a pool of its own) timed with CUDA
        events, on the CPU (and under Gloo) eager runs on the host clock."""
        best = float("inf")
        if not self.graphs:
            for _ in range(2):
                restore()
                t0 = time.perf_counter()
                fn()
                if self.device.type == "cuda":  # eager under Gloo
                    torch.cuda.synchronize(self.device)
                best = min(best, (time.perf_counter() - t0) * 1e3)
            return best
        restore()
        graph, _ = self.capture(fn)
        for _ in range(2):
            restore()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    def calibrate(self, depths: torch.Tensor, rgbs: Optional[torch.Tensor],
                  colors: Sequence[bool], cap: int) -> Tuple[float, float]:
        """(preprocess ms, fusion ms) per frame of these frames: a
        preprocess-only loop over them, then a fuse-only loop over its
        points and normals into a device copy of the rows (and of the
        sat_skip bitset) at the current pose (fusion's cost hardly depends
        on the pose). Launches here are a measurement and are not
        counted."""
        r = self.recon
        n = len(colors)
        t0 = time.perf_counter()
        before = launch_counts()
        D = depths.to(self.device)
        RGB = None if rgbs is None else rgbs.to(self.device)
        h, w = D.shape[1:3]
        PTS = torch.empty((n, h, w, 3), dtype=torch.float32, device=self.device)
        NRM = torch.empty_like(PTS)

        def prep():
            for k in range(n):
                pts, nrm = self._preprocess(D[k])
                PTS[k].copy_(pts)
                NRM[k].copy_(nrm)

        live = r._bgrid
        snap = BrickGrid(*(x.clone() for x in (live.D, live.W, live.C)))
        sat = None if r._sat is None else r._sat.clone()
        pose = Pose(r.pose.R.clone(), r.pose.t.clone())

        def restore():
            for dst, src in zip((snap.D, snap.W, snap.C), (live.D, live.W, live.C)):
                dst.copy_(src)
            if sat is not None:
                sat.copy_(r._sat)

        def fuse():
            for k in range(n):
                rgb = self._decode_rgb(RGB[k]) if colors[k] else None
                r._fuse_core(pose, PTS[k], NRM[k], rgb, cap, bgrid=snap, sat=sat)

        try:
            prep_ms = self._timed_ms(prep, lambda: None)
            fuse_ms = self._timed_ms(fuse, restore)
        finally:
            _set_launch_counts(before)
        self.calibration_ms.append((time.perf_counter() - t0) * 1e3)
        return prep_ms / n, fuse_ms / n


def color_cadence(first: int, n: int, has_color: bool, color_every: int) -> List[bool]:
    """Which of n frames, the first with absolute index ``first``, fuse
    color: the per-frame path's ``frame_num % color_every == 0``."""
    return [has_color and (color_every <= 1 or (first + k) % color_every == 0)
            for k in range(n)]
