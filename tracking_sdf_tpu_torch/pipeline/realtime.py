"""Paced, arrival-driven replay (counterpart of
tracking_sdf_tpu.pipeline.realtime's RealtimePacer and
MultihostRealtimePacer).

A live sensor delivers frames at its own rate into a queue of size one: when
the consumer is still busy, every frame but the newest is dropped, and the
tracker must bridge the larger motion. ``RealtimePacer`` gives any indexable
dataset these semantics. The first ``warmup`` frames (default 2) are
delivered un-paced and never dropped: they carry first-use costs (kernel
builds, graph captures). The arrival clock then starts with the next frame
arriving now: frame i arrives (i - warmup) / hz later. Each pull yields the
newest frame that has arrived and counts the older unconsumed ones as
dropped; a consumer ahead of the sensor blocks until the next arrival.
"""
from __future__ import annotations

import time
from typing import Iterator, Tuple

import torch


class RealtimePacer:
    """Wrap an indexable dataset in queue-size-1 paced-arrival semantics.
    ``dropped`` counts the frames skipped because a newer one had arrived,
    ``yielded`` the frames delivered."""

    def __init__(self, dataset, hz: float = 30.0, warmup: int = 2):
        if hz <= 0:
            raise ValueError(f"hz must be positive, got {hz}")
        self._ds = dataset
        self._hz = float(hz)
        self._warmup = max(int(warmup), 0)
        self.dropped = 0
        self.yielded = 0
        # forwarded so that an evaluation finds it on the wrapped dataset
        self.groundtruth = getattr(dataset, "groundtruth", None)

    def __len__(self) -> int:
        return len(self._ds)

    def paced(self) -> Iterator[Tuple[int, object]]:
        """(index, frame) of each delivered frame; the one place that owns
        the arrival clock and the drop accounting."""
        n = len(self._ds)
        i = 0  # next unconsumed frame index
        while i < min(self._warmup, n):
            self.yielded += 1
            yield i, self._ds[i]
            i += 1
        t0 = time.perf_counter() - i / self._hz  # frame i arrives now
        while i < n:
            elapsed = time.perf_counter() - t0
            latest = min(int(elapsed * self._hz), n - 1)
            if latest < i:  # ahead of the sensor: wait for frame i
                time.sleep(max(i / self._hz - elapsed, 0.0))
                latest = i
            self.dropped += latest - i
            self.yielded += 1
            yield latest, self._ds[latest]
            i = latest + 1

    def __iter__(self):
        for _, frame in self.paced():
            yield frame


class MultihostRealtimePacer(RealtimePacer):
    """The paced replay of a mesh's ranks in lockstep: wall clocks of their
    own would drop different frames on different ranks, and the ranks'
    collectives would then disagree. Rank 0 runs the arrival clock
    (``paced()``, its sleeps included) and broadcasts each chosen index
    before the frame is yielded, then -1 at the end; the other ranks yield
    the frames of the indices they receive and rebuild the drop count from
    the gaps between them (the warm-up frames are consecutive), so every
    rank delivers the same frames and counts the same drops.
    ``mesh``: parallel.mesh.Mesh (one broadcast of one int64 a frame)."""

    def __init__(self, dataset, mesh, hz: float = 30.0, warmup: int = 2):
        super().__init__(dataset, hz=hz, warmup=warmup)
        self._mesh = mesh
        self._idx = torch.zeros((), dtype=torch.int64, device=mesh.device)

    def _bcast(self, idx: int) -> int:
        self._idx.fill_(idx)
        return int(self._mesh.broadcast_(self._idx, src=0))

    def __iter__(self):
        if self._mesh.rank == 0:
            for i, frame in self.paced():
                self._bcast(i)
                yield frame
            self._bcast(-1)
            return
        yield from (self._ds[i] for i in self.follow(iter(lambda: self._bcast(0), -1)))

    def follow(self, indices) -> Iterator[int]:
        """A follower's accounting over a stream of broadcast indices: yields
        each index and counts the frames skipped between two as dropped."""
        prev = -1
        for idx in indices:
            if prev >= 0:
                self.dropped += max(idx - prev - 1, 0)
            self.yielded += 1
            prev = idx
            yield idx
