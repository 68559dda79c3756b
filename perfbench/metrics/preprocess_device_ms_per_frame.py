"""Device time of the preprocess layer's kernels (perfbench/layers/preprocess/)
in the profiled chunks, over their frames, in ms."""


def read(ctx):
    frames = len(ctx["traced"]["frames"])
    s = ctx["trace"]["layer_s"].get("preprocess")
    return None if not frames or s is None else 1e3 * s / frames
