"""Profiling utilities (counterpart of tracking_sdf_tpu.utils.profiling).

* :class:`Timer`: accumulating wall-clock phase timer;
* :func:`device_timer`: the same, but the clock stops only after the device
  has finished its queued work (PyTorch returns before the GPU does);
* :func:`trace`: a ``torch.profiler`` trace of the block, exported as a
  Chrome trace (chrome://tracing, Perfetto) into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

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
