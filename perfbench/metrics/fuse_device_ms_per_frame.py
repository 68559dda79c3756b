"""Device time of the fusion layer's kernels (perfbench/layers/fusion/)
in the profiled chunks, over their frames, in ms."""


def read(ctx):
    frames = len(ctx["traced"]["frames"])
    s = ctx["trace"]["layer_s"].get("fusion")
    return None if not frames or s is None else 1e3 * s / frames
