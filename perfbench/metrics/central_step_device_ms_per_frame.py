"""Device time of K1's central form (gn_central_step_kernel: the 13-probe
central-difference Gauss-Newton step on the D and W rows) in the profiled
chunks, over their frames, in ms. Nothing where the kernel did not run."""


def read(ctx):
    frames = len(ctx["traced"]["frames"])
    t = sum(s for k, s in ctx["trace"]["kernel_s"].items() if "gn_central_step_kernel" in k)
    return 1e3 * t / frames if frames and t > 0 else None
