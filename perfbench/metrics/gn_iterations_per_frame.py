"""Gauss-Newton iterations of the finest pyramid level a frame, from the
frames' records, over the window."""


def read(ctx):
    it = ctx["window"].iterations
    return sum(it) / len(it) if it else None
