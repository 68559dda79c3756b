"""The port's kernel launches a frame over the window: the deltas of its
launch counters (a replay adds what its capture recorded) over the frames."""


def read(ctx):
    frames = ctx["window"].frames
    return sum(ctx["launches"]) / frames if frames else None
