"""K1's (gn_step) share of its roofline: the least time of the work the
profiled frames' records say K1 did (harness.bounds.k1_frame_s: full steps
only, at their levels' query counts; done launches do no work) over K1's
device time in the trace, in %."""


def read(ctx):
    pk, frames = ctx["peaks"], ctx["traced"]["frames"]
    t = sum(s for k, s in ctx["trace"]["kernel_s"].items() if "gn_step_kernel" in k)
    if pk is None or not frames or t <= 0:
        return None
    least = sum(ctx["bounds"].k1_frame_s(ctx["cfg"], ctx["hw"], it, nv, pk)
                for it, nv in frames if it > 0)
    return 100.0 * least / t
