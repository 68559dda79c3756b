"""The traced run's ``frames_per_s``, as the end-to-end metric is worked
out over its window: a per-layer reading for cells whose pace the host's
speed sets, so that its runs spread too widely to gate it end to end. The
profiled groups are inside the window."""

from harness import cell


def read(ctx):
    win = ctx["window"]
    if not win.walls or win.seconds <= 0:
        return None
    return cell.end_to_end(win, 0.0)["frames_per_s"]["value"]
