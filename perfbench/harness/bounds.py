"""The card's peaks and the least time of the kernels whose roofline shares
the benchmark reports, from the work the records say was done.

A kernel's least time is the larger of its bytes (each input byte read
once, each output byte written once) over the memory rate and its float32
operations over the float32 rate (the chip_smoke.py counts of the port).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

# NVIDIA's data sheet for the H100 SXM at its full 700 W (dense rates)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12,
                              "bf16_flop_per_s": 989e12},
}

K1_FLOP_PER_QUERY = 280  # a valid query: pose, 8 corners, gradient, J, J^T J
K1_STATE_BYTES = 2 * 24 * 4  # the 24-slot float32 state read and written
FLOAT_BYTES = 4


def peaks(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)


def least_s(nbytes: float, flops: float, pk: dict) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["f32_flop_per_s"])


def level_queries(hw, stride: int) -> int:
    """Queries of a level: the strided pixel lattice."""
    return math.ceil(hw[0] / stride) * math.ceil(hw[1] / stride)


def k1_frame_s(cfg: dict, hw, iterations: int, num_valid: float, pk: dict) -> float:
    """K1's least time for one tracked frame: each full step reads its
    level's points (12 B a query) and the 8 bf16 or float32 corners of each
    valid query, and reads and writes the state; done launches do no work.
    The records give the finest level's iterations and valid count; each
    coarser level is counted at one step (the least a level runs) with the
    finest level's valid share."""
    t, f, p = cfg["tracking"], cfg["fusion"], cfg["pipeline"]
    elem = 2 if f["storage_dtype"] == "bfloat16" else 4
    levels = p["pyramid_levels"] or [1]
    n_fine = level_queries(hw, t["pixel_stride"])
    share = num_valid / n_fine
    total = 0.0
    for mult in levels:
        n = level_queries(hw, t["pixel_stride"] * mult)
        v = num_valid if mult == 1 else share * n
        steps = iterations if mult == 1 else 1
        total += steps * least_s(n * 3 * FLOAT_BYTES + v * 8 * elem + K1_STATE_BYTES,
                                 v * K1_FLOP_PER_QUERY, pk)
    return total


def k2_frame_s(cfg: dict, hw, counts: Sequence[int], color: bool, pk: dict) -> float:
    """K2's least time for one fused frame from its counts (n_full, n_free,
    ...): the D and W rows of the FULL and FREE bricks kept under the caps
    read and written once, with color the packed color row of each FULL
    brick too, the pixel rows of the FULL bricks' share groups (at most one
    a group, at most the image), the lists and the pose."""
    f = cfg["fusion"]
    bs = f["brick_shape"]
    bv = bs[0] * bs[1] * bs[2]
    vb = 2 if f["storage_dtype"] == "bfloat16" else 4
    wb = 2 if f["weight_dtype"] == "bfloat16" else 4
    cap, cap_free = f["brick_cap"], f["brick_cap_free"] or f["brick_cap"]
    n_full, n_free = min(counts[0], cap), min(counts[1], cap_free)
    row = bv * 2 * (vb + wb)
    crow = (3 * bv * vb + bv * wb) * 2
    sj = f["pixel_share_j"] if bs[1] % f["pixel_share_j"] == 0 else 1
    sk = f["pixel_share"] if bs[2] % f["pixel_share"] == 0 else 1
    channels = 8 if color else 4
    pixels = min(n_full * bv // (sj * sk), hw[0] * hw[1])
    nbytes = (n_full * (row + (crow if color else 0)) + n_free * row
              + pixels * channels * FLOAT_BYTES + (cap + cap_free) * 4 + 48)
    return least_s(nbytes, 0.0, pk)
