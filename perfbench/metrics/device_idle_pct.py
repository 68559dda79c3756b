"""The share of the traced window (the profiled groups of chunks, from the
first chunk's start to the last's end) in which no kernel or copy ran on
the device: one less the union of the device intervals over it, in %."""


def read(ctx):
    red = ctx["trace"]
    if red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
