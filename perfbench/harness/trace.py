"""Reduction of the profiler's trace of the sampled chunks to per-kernel,
per-layer and idle times.

An event here is a dict: name, dev ("cpu" or "cuda"), start and end in
microseconds on the profiler's clock, and ``parents``, the names of the
host ops it ran inside (innermost first). The harness wraps each profiled
chunk in a host span named ``CHUNK_SPAN``; the traced window is the time
from a group's first chunk span to its last.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from harness.data import layer_of

CHUNK_SPAN = "perfbench.chunk"
# host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
REPLAY_CALL = "cudaGraphLaunch"
# what the host was doing, in a chunk's order
PHASES = ("chunk set-up", "issuing replays", "reading records", "post-processing stats")
HARNESS = "harness"


def simplify(function_events) -> List[dict]:
    """torch.profiler FunctionEvents -> event dicts."""
    from torch.autograd import DeviceType

    out = []
    for e in function_events:
        parents, p = [], e.cpu_parent
        while p is not None:
            parents.append(p.name)
            p = p.cpu_parent
        out.append(dict(name=e.name, dev="cuda" if e.device_type == DeviceType.CUDA else "cpu",
                        start=float(e.time_range.start), end=float(e.time_range.end),
                        parents=parents))
    return out


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted disjoint union of intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _blocking(e: dict) -> bool:
    """A host call that waits for the device: a synchronize, or a copy made
    for a device-to-host ``.to()`` (the records' read)."""
    return (e["dev"] == "cpu" and (e["name"] in SYNC_CALLS or (
        e["name"].startswith("cudaMemcpy") and "aten::_to_copy" in e["parents"])))


def chunk_phases(span: dict, cpu: List[dict]) -> Dict[str, List[Tuple[float, float]]]:
    """The intervals of a chunk span in each of PHASES: until the first
    replay, until the first blocking call, the blocking calls, after them."""
    inside = [e for e in cpu if e["start"] >= span["start"] and e["end"] <= span["end"]]
    launches = [e["start"] for e in inside if e["name"] == REPLAY_CALL]
    blocks = union([(e["start"], e["end"]) for e in inside if _blocking(e)])
    s, e = span["start"], span["end"]
    first = min(launches) if launches else s
    b0 = blocks[0][0] if blocks else e
    b1 = blocks[-1][1] if blocks else e
    return {"chunk set-up": [(s, first)], "issuing replays": [(first, b0)],
            "reading records": blocks, "post-processing stats": [(b1, e)]}


def reduce(groups: Sequence[List[dict]], patterns) -> dict:
    """Per-kernel and per-layer device seconds, busy and window seconds,
    each chunk's wall and blocked seconds, and the idle seconds by what the
    host was doing, over the profiled groups."""
    kern_s: Dict[str, float] = {}
    kern_n: Dict[str, int] = {}
    layer_s: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    busy = window = 0.0
    chunk_s, blocked_s = [], []
    for events in groups:
        cpu = [e for e in events if e["dev"] == "cpu"]
        spans = sorted((e for e in cpu if e["name"] == CHUNK_SPAN), key=lambda e: e["start"])
        if not spans:
            continue
        lo, hi = spans[0]["start"], spans[-1]["end"]
        dev = [e for e in events if e["dev"] == "cuda" and not e["name"].startswith("perfbench.")
               and e["end"] > lo and e["start"] < hi]
        for e in dev:
            d = (min(e["end"], hi) - max(e["start"], lo)) * 1e-6
            kern_s[e["name"]] = kern_s.get(e["name"], 0.0) + d
            kern_n[e["name"]] = kern_n.get(e["name"], 0) + 1
            layer = layer_of(e["name"], patterns)
            layer_s[layer] = layer_s.get(layer, 0.0) + d
        dev_u = clip(union([(e["start"], e["end"]) for e in dev]), lo, hi)
        busy += total(dev_u) * 1e-6
        window += (hi - lo) * 1e-6
        gaps, t = [], lo
        for a, b in dev_u:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        phases = {HARNESS: []}
        covered = []
        for sp in spans:
            ph = chunk_phases(sp, cpu)
            for k, iv in ph.items():
                phases.setdefault(k, []).extend(iv)
            covered.append((sp["start"], sp["end"]))
            chunk_s.append((sp["end"] - sp["start"]) * 1e-6)
            blocked_s.append(total(ph["reading records"]) * 1e-6)
        t = lo
        for a, b in union(covered):
            if a > t:
                phases[HARNESS].append((t, a))
            t = b
        for k, iv in phases.items():
            for ga, gb in gaps:
                s = total(clip(iv, ga, gb)) * 1e-6
                if s > 0:
                    idle[k] = idle.get(k, 0.0) + s
    return dict(kernel_s=kern_s, kernel_n=kern_n, layer_s=layer_s, busy_s=busy,
                window_s=window, chunk_s=chunk_s, blocked_s=blocked_s, idle_s=idle)


def breakdown(red: dict, n: int = 10) -> dict:
    """The device operations that took the most time and the idle time by
    what the host was doing, each at most ``n`` entries, in seconds."""
    ops = sorted(red["kernel_s"].items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(red["idle_s"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
