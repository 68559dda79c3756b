"""Profiling utilities (counterpart of tracking_sdf_tpu.utils.profiling).

* :class:`Timer`: accumulating wall-clock phase timer;
* :func:`device_timer`: the same, but the clock stops only after the device
  has finished its queued work (PyTorch returns before the GPU does);
* :func:`trace`: a ``torch.profiler`` trace of the block, exported as a
  Chrome trace (chrome://tracing, Perfetto) into a directory;
* tracing inside the program, one switch (:func:`enable_tracing`, off by
  default; ``cli --profile DIR`` turns it on for the run): :func:`span`
  marks a phase of the host's work as a range on the profiler's clock, and
  the chunk step runs its traced variant (per-frame device stamps by
  :func:`device_stamp` and per-level GN counts in the frame's record,
  pipeline.chunk). Off, a span costs one test and the step is the untraced
  one; a profiler alone changes neither.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Timer:
    """Accumulating phase timer: `with timer("fuse"): ...`; `timer.report()`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def mean_ms(self, phase: str) -> float:
        n = self.counts.get(phase, 0)
        return 1e3 * self.totals[phase] / n if n else 0.0

    def report(self) -> str:
        return "\n".join(
            f"{phase}: {self.mean_ms(phase):.2f} ms/call x{self.counts[phase]} "
            f"(total {self.totals[phase]:.3f} s)" for phase in sorted(self.totals))


@contextlib.contextmanager
def device_timer(timer: Timer, phase: str, device):
    """Like ``timer(phase)``, ending with ``torch.cuda.synchronize(device)``
    when ``device`` is a GPU, so queued work is inside the measured time."""
    device = torch.device(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timer.totals[phase] += time.perf_counter() - t0
        timer.counts[phase] += 1


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (host, and the GPU when there is
    one) and write ``trace.json`` (Chrome trace format) into ``log_dir``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# --- tracing inside the program ---------------------------------------------

_tracing = False
_NULL = contextlib.nullcontext()


def enable_tracing(on: bool = True) -> None:
    """Turn the port's tracing on or off for the process (off by default)."""
    global _tracing
    _tracing = bool(on)


def tracing_enabled() -> bool:
    """Whether spans are marked and the chunk step runs its traced variant."""
    return _tracing


def span(name: str, id: Optional[int] = None):
    """A context manager that marks the block as the range ``name`` on the
    profiler's clock while tracing, and does nothing otherwise. ``id`` is
    the range's input, seen where the profiler records shapes. The range is
    function-scope: unlike a user annotation (torch.profiler.record_function)
    it puts no range on the device's timeline, where a reader of device
    intervals would count it as device time."""
    if not _tracing:
        return _NULL
    rf = torch._C._profiler._RecordFunctionFast
    return rf(name) if id is None else rf(name, [id])  # inputs, when given, a list


def device_stamp(out: torch.Tensor) -> None:
    """Write the device's clock into ``out``, one int64 in nanoseconds: on
    the card the ``%globaltimer`` that every SM shares, read by a one-thread
    kernel on the current stream (csrc/stamp.cu; in a CUDA graph, a node
    of it); on the CPU the host's ``time.perf_counter_ns()``."""
    if out.dtype != torch.int64 or out.numel() != 1:
        raise ValueError(f"device_stamp: one int64 slot, not {out.dtype} {tuple(out.shape)}")
    if out.device.type != "cuda":
        out.fill_(time.perf_counter_ns())
        return
    from tracking_sdf_tpu_torch.kernels import _build

    rc = _build.library().tsdf_device_stamp(out.data_ptr(), _build.stream_ptr(out.device))
    _build.check(rc, "device_stamp")
