"""K2's (brick_fuse_rows) share of its roofline: the least time of the rows
that the profiled frames' fusion counts say K2 merged
(harness.bounds.k2_frame_s) over K2's device time in the trace, in %."""


def read(ctx):
    pk, traced = ctx["peaks"], ctx["traced"]
    t = sum(s for k, s in ctx["trace"]["kernel_s"].items() if "brick_fuse_rows_kernel" in k)
    if pk is None or t <= 0:
        return None
    least = sum(ctx["bounds"].k2_frame_s(ctx["cfg"], ctx["hw"], c, color, pk)
                for c, color in zip(traced["counts"], traced["colors"]) if c is not None)
    return 100.0 * least / t if least > 0 else None
