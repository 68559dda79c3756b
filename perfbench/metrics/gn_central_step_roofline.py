"""K1's central form's (gn_central_step_kernel) share of its roofline, in
%: the least time of the full steps that the profiled frames' records
report (their GN iterations; the configuration tracks one level at
``pixel_stride``; launches after convergence do no work) over the
kernel's device time in the trace.

A full step's least time at its level's query count n with v valid
queries is ``bounds.least_s`` of
  bytes: the points (12 B a query), the 8 corners of D and of W of each of
         a valid query's 13 probes (13 x 8 x (D + W bytes)), and the 24-slot
         state read and written. The corners are counted as reads, not as
         distinct bytes: the probes of one query share corners (a +-1 voxel
         probe 4 of its 8 with the value probe), neighbouring queries share
         voxels, and tum256's D and W rows fit in the card's L2, so the
         bytes a full step must move from memory are fewer and the share
         reads higher than a bound on distinct bytes would give;
  operations: FLOP_PER_QUERY a valid query, the kernel's float32
         operations, an FMA counted as 2: the world point 18 (per axis a
         multiply, 2 FMA and the add of t), its voxel coordinates 9, the
         translation probes 6, the rotation probes 102 (x - t 3, then per
         axis the cross product 9, x +- it 6 and their voxel coordinates
         18), each of the 13 probes 66 (6 corner shares |b + o - c| at 2,
         8 distances of 2 adds, 8 reciprocals, 8 products, three 8-term
         sums of 7 adds and 1 division), the 6 Jacobian columns 12, the 27
         products of J^T J and J r and |r| 1:
         18 + 9 + 6 + 102 + 858 + 12 + 27 + 1.
"""

FLOP_PER_QUERY = 1033


def step_s(cfg: dict, bounds, hw, num_valid: float, pk: dict) -> float:
    """The least time of one full central step at the finest level."""
    f = cfg["fusion"]
    d = 2 if f["storage_dtype"] == "bfloat16" else 4
    w = 2 if f["weight_dtype"] == "bfloat16" else 4
    n = bounds.level_queries(hw, cfg["tracking"]["pixel_stride"])
    nbytes = (n * 3 * bounds.FLOAT_BYTES + num_valid * 13 * 8 * (d + w)
              + bounds.K1_STATE_BYTES)
    return bounds.least_s(nbytes, num_valid * FLOP_PER_QUERY, pk)


def read(ctx):
    pk, frames = ctx["peaks"], ctx["traced"]["frames"]
    t = sum(s for k, s in ctx["trace"]["kernel_s"].items() if "gn_central_step_kernel" in k)
    if pk is None or not frames or t <= 0:
        return None
    least = sum(it * step_s(ctx["cfg"], ctx["bounds"], ctx["hw"], nv, pk)
                for it, nv in frames if it > 0)
    return 100.0 * least / t
