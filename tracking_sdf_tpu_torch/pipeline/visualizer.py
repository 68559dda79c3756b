"""Asynchronous mesh publisher (counterpart of
tracking_sdf_tpu.pipeline.visualizer): a background thread that exports the
latest grid snapshot at a fixed rate while the frame loop goes on.

The snapshot is a copy of the grid made on the caller's stream after the
frame's kernels, so the loop's in-place updates never reach it. The export
function decides what else it must exclude (the runner's takes the device
lock of pipeline.chunk, so a CUDA-graph capture or a replay under the
no-sync guard never overlaps the publisher's work on the card).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Callable, Optional

import torch


def _copy(snapshot):
    """A device copy of every tensor in a grid-like snapshot."""
    if torch.is_tensor(snapshot):
        return snapshot.clone()
    if dataclasses.is_dataclass(snapshot):
        return dataclasses.replace(snapshot, **{
            f.name: _copy(getattr(snapshot, f.name)) for f in dataclasses.fields(snapshot)})
    if isinstance(snapshot, dict):
        return {k: _copy(v) for k, v in snapshot.items()}
    if isinstance(snapshot, (list, tuple)):
        return type(snapshot)(_copy(v) for v in snapshot)
    return snapshot


class MeshPublisher:
    """Every ``interval`` seconds, hand the latest snapshot to ``export_fn``.

    Waits for the first ``publish``, then loops until ``close()``. When one
    export takes longer than the interval, the interval stretches to the
    export's time times ``degrade_headroom`` (never a queue behind the
    device), which ``effective_interval``, ``degraded_cycles`` and a
    one-time RuntimeWarning report. ``published``, ``errors`` and
    ``last_error`` count the outcomes; an export's exception never escapes
    the thread."""

    def __init__(self, export_fn: Callable[[object], None], interval: float = 1.0,
                 degrade_headroom: float = 1.1):
        self._export = export_fn
        self.interval = interval
        self.effective_interval = interval
        self.degrade_headroom = degrade_headroom
        self.degraded_cycles = 0
        self._warned = False
        self._snapshot = None
        self._have_data = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.published = 0
        self.errors = 0
        self.last_export_s = 0.0
        self.last_error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def publish(self, grid, copy: bool = True) -> None:
        """Hand over the current snapshot (non-blocking). ``copy`` False
        hands over ``grid`` itself: only for tensors that nothing updates
        afterwards (a freshly materialized dense view)."""
        snap = _copy(grid) if copy else grid
        with self._lock:
            self._snapshot = snap
        self._have_data.set()

    def _export_once(self, snap) -> None:
        try:
            self._export(snap)
            self.published += 1
        except Exception as e:  # reported through errors / last_error
            self.errors += 1
            self.last_error = e

    def _loop(self) -> None:
        while not self._stop.is_set():  # wait for the first snapshot
            if self._have_data.wait(timeout=0.1):
                break
        while not self._stop.is_set():
            with self._lock:
                snap = self._snapshot
            if snap is not None:
                t0 = time.perf_counter()
                self._export_once(snap)
                self.last_export_s = time.perf_counter() - t0
                want = self.last_export_s * self.degrade_headroom
                if want > self.interval:
                    self.degraded_cycles += 1
                    self.effective_interval = want
                    if not self._warned:
                        self._warned = True
                        warnings.warn(
                            f"mesh publisher: export takes {self.last_export_s:.1f} s > "
                            f"requested interval {self.interval:.1f} s; publishing every "
                            f"~{want:.1f} s instead (see effective_interval / "
                            f"config.mesh_decimate for a coarser, faster live mesh)",
                            RuntimeWarning, stacklevel=2)
                else:
                    self.effective_interval = self.interval
            if self._stop.wait(timeout=self.effective_interval):
                break

    def close(self, final: bool = True) -> None:
        """Stop the thread, then (``final``) export the last snapshot once
        more. If the thread is still inside an export after 30 s, that
        export is the final one: a second would race it on the same file."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            return
        if final and self._snapshot is not None:
            self._export_once(self._snapshot)
