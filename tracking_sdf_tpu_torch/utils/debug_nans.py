"""``--debug-nans``: the grid's and the pose's invariants, checked after
every frame on the device (the counterpart of the JAX package's
``jax.config.update("jax_debug_nans", True)``).

JAX's flag traps the first operation that makes a NaN. The system carries
NaN on purpose: depth holes, scene misses, D wherever W <= 0 (the brick-major
storage invariant) and a rejected chunk frame's points, so such a trap fires
on every path. This switch keeps the flag's purpose, to fail fast at the
frame that put a NaN where none belongs, by checking what a frame leaves
behind:

  * no NaN (or infinity) in D where W > 0;
  * W finite and >= 0;
  * Wc finite and >= 0, and R, G, B finite where Wc > 0;
  * a finite pose (R, t).

The runner checks the rows the frame wrote (brick-major: the compacted FULL
and FREE lists) or the whole grid (dense and flat layouts, a grid assignment,
a restored checkpoint). The counts stay on the device and reach the host with
the frame's FuseStats counts (per frame) or in the chunk's record, so the
check adds no host read; ``check`` raises FloatingPointError (JAX's
exception type) naming the frame, the invariant and the count of bad values.
The check only reads: a clean run is the run without it, bit for bit.
"""
from __future__ import annotations

import contextlib

import torch

INVARIANTS = ("NaN in D where W > 0", "W not finite or negative",
              "color not finite where Wc > 0 (or Wc not finite or negative)",
              "pose (R, t) not finite")
_K = len(INVARIANTS)
_MAX_COUNT = (1 << 28) - 1  # a code fits in an int32 whose float32 bits are no NaN

_enabled = False


def enabled() -> bool:
    """Whether the switch is on (process-wide)."""
    return _enabled


@contextlib.contextmanager
def switch(on: bool = True):
    """Turn the switch on (``on`` False leaves it as it is) until the block
    ends, then restore it."""
    global _enabled
    prev = _enabled
    _enabled = prev or on
    try:
        yield
    finally:
        _enabled = prev


def leaf_faults(D, W, R, G, B, Wc, valid=None) -> torch.Tensor:
    """(3,) int64 on the leaves' device: the values that break each of the
    first three invariants, over the entries where ``valid`` (broadcast to
    the leaves) holds, or all of them."""
    W, Wc = W.float(), Wc.float()
    color = torch.isfinite(R.float()) & torch.isfinite(G.float()) & torch.isfinite(B.float())
    bad = (
        (W > 0) & ~torch.isfinite(D.float()),
        ~torch.isfinite(W) | (W < 0),
        ~torch.isfinite(Wc) | (Wc < 0) | ((Wc > 0) & ~color),
    )
    if valid is not None:
        bad = tuple(b & valid for b in bad)
    return torch.stack([b.sum() for b in bad])


def grid_faults(grid) -> torch.Tensor:
    """leaf_faults over a whole dense grid (or slab)."""
    return leaf_faults(grid.D, grid.W, grid.R, grid.G, grid.B, grid.Wc)


def pose_faults(pose) -> torch.Tensor:
    """(1,) int64: the entries of R and t that are not finite."""
    return (~torch.isfinite(pose.R)).sum()[None] + (~torch.isfinite(pose.t)).sum()[None]


def fault_code(faults: torch.Tensor) -> torch.Tensor:
    """The four counts (leaf_faults, then pose_faults) as one () int64 on
    the device: n * 4 + k for the first broken invariant k and its count n,
    0 when every invariant holds."""
    k = torch.argmax((faults > 0).to(torch.int64)).reshape(1)
    # gather, not faults[k]: indexing by a 0-dim tensor reads it on the host
    return (torch.clamp(faults.gather(0, k), max=_MAX_COUNT) * _K + k)[0]


def check(code: int, where: str) -> None:
    """Raise FloatingPointError when ``code`` (fault_code, read on the host)
    is not 0; ``where`` names the frame."""
    if code:
        n, k = divmod(int(code), _K)
        raise FloatingPointError(f"--debug-nans: {where} broke an invariant of the grid: "
                                 f"{INVARIANTS[k]} ({n} values)")
