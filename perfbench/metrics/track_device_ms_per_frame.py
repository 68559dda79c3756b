"""Device time of the tracking layer's kernels (perfbench/layers/tracking/)
in the profiled chunks, over their frames, in ms."""


def read(ctx):
    frames = len(ctx["traced"]["frames"])
    s = ctx["trace"]["layer_s"].get("tracking")
    return None if not frames or s is None else 1e3 * s / frames
