"""The share of K1's central launches that did a step's work, over the
window, in %: the full central steps the frames' records report (their GN
iterations: the configuration tracks one level) over the launches of
gn_central_step_kernel the program counted (a level issues
max_iterations launches; those after it converged return at once).
Nothing where the program has no such counter, or counted no launch."""


def read(ctx):
    from tracking_sdf_tpu_torch.pipeline import chunk

    names = getattr(chunk, "LAUNCH_COUNTERS", ())
    if "gn_reduce.launches_step_central" not in names:
        return None
    launches = ctx["launches"][names.index("gn_reduce.launches_step_central")]
    return 100.0 * sum(ctx["window"].iterations) / launches if launches > 0 else None
