"""The port's RealtimePacer against the JAX package's, on a fake clock.

``time.perf_counter`` and ``time.sleep`` are replaced by a clock that only
the test and the pacer's own sleeps advance; the consumer "works" for a
scripted time after each frame. Both pacers must deliver the same frame
indices and count the same ``dropped`` and ``yielded`` (exactly).
"""
import time

import pytest

from tracking_sdf_tpu.pipeline.realtime import RealtimePacer as JRealtimePacer
from tracking_sdf_tpu_torch.pipeline.realtime import RealtimePacer


class FakeClock:
    def __init__(self):
        self.now = 100.0
        self.slept = []

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        assert s >= 0.0
        self.slept.append(s)
        self.now += s


class Indexed:
    """A dataset whose frame i is the integer i."""

    groundtruth = "gt"

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        assert 0 <= i < self.n
        return i


def consume(pacer_cls, monkeypatch, n, work, **kw):
    """Pull every frame, working ``work(k)`` seconds after the k-th pull."""
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    pacer = pacer_cls(Indexed(n), **kw)
    got = []
    for k, frame in enumerate(pacer):
        got.append(frame)
        clock.now += work(k)
    return got, pacer.dropped, pacer.yielded, clock.slept, pacer


SCHEDULES = {
    "fast": lambda k: 0.001,                      # ahead of the sensor: it sleeps
    "slow": lambda k: 0.1,                        # 3 frames of work: it drops
    "exact": lambda k: 1.0 / 30.0,
    "warmup_heavy": lambda k: 5.0 if k < 2 else 0.01,  # first uses cost seconds
    "bursty": lambda k: (0.005, 0.2, 0.04, 0.0, 0.5)[k % 5],
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("hz,warmup", [(30.0, 2), (10.0, 0), (120.0, 3)])
def test_pacer_matches_jax(monkeypatch, schedule, hz, warmup):
    work = SCHEDULES[schedule]
    ours = consume(RealtimePacer, monkeypatch, 40, work, hz=hz, warmup=warmup)
    theirs = consume(JRealtimePacer, monkeypatch, 40, work, hz=hz, warmup=warmup)
    assert ours[:4] == theirs[:4]
    got, dropped, yielded = ours[:3]
    assert got == sorted(set(got)) and got[:warmup] == list(range(warmup))
    assert yielded == len(got) and yielded + dropped == got[-1] + 1
    assert got[-1] == 39  # the newest frame is always delivered in the end


def test_pacer_semantics(monkeypatch):
    """The warm-up frames are never dropped however long they take; a slow
    consumer then drops, a fast one sleeps until the next arrival."""
    got, dropped, yielded, slept, pacer = consume(
        RealtimePacer, monkeypatch, 20, SCHEDULES["warmup_heavy"], hz=30.0)
    assert got == list(range(20)) and dropped == 0 and yielded == 20
    waits = [s for s in slept if s > 1e-9]  # frame 2 arrives as the clock starts
    assert len(waits) == 17 and all(s < 1.0 / 30.0 for s in waits)
    assert pacer.groundtruth == "gt" and len(pacer) == 20
    got, dropped, yielded, slept, _ = consume(
        RealtimePacer, monkeypatch, 20, SCHEDULES["slow"], hz=30.0)
    assert got[:3] == [0, 1, 2] and dropped > 0 and yielded + dropped == 20 and not slept[1:]
    # paced() exposes the chosen index beside the frame
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    assert [i for i, f in RealtimePacer(Indexed(5), hz=30.0).paced()] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("n,warmup", [(0, 2), (1, 2), (2, 2), (3, 5)])
def test_pacer_short_datasets(monkeypatch, n, warmup):
    ours = consume(RealtimePacer, monkeypatch, n, lambda k: 0.5, hz=30.0, warmup=warmup)
    theirs = consume(JRealtimePacer, monkeypatch, n, lambda k: 0.5, hz=30.0, warmup=warmup)
    assert ours[:4] == theirs[:4] and ours[0] == list(range(n))


def test_pacer_rejects_a_bad_rate():
    for hz in (0.0, -5.0):
        with pytest.raises(ValueError):
            RealtimePacer(Indexed(3), hz=hz)
