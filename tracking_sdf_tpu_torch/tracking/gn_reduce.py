"""K1: the Gauss-Newton normal equations (A = JᵀJ, b = Jᵀr) and the whole
Gauss-Newton step built on them.

Counterpart of tracking_sdf_tpu/tracking/pallas_gn.py (the reduction), of
the ``lax.while_loop`` body of tracking_sdf_tpu/tracking/gauss_newton.py
(the step) and of the body of tracking_sdf_tpu/parallel/sharded.py's
``_local_gn`` (the sharded step around its ``psum``). The CUDA kernels
(``csrc/gn_reduce.cu``) replace the Pallas ``_gn_kernel`` together with its
XLA front half ``gather_corner_inputs``: each GPU thread gathers its own
corners from the masked view. Views: the dense float32 (m, m, m) view (the
flat bricked loop) and the brick-major ``BrickMaskedView`` of float32 or
bfloat16 D rows (the presets' main path). The source note there says what
bounds the kernels on the card and what the design does about it.

``gn_reduce`` / ``gn_reduce_reference`` return 29 float32 values (``unpack``
turns them back into A (6, 6), b (6,), the valid count and Σ|r| over valid
queries); on the card ``gn_reduce`` is one launch of K1's slab form over the
whole grid. ``query_terms_reference`` gives the plain version's 29 terms of
each query, which the kernels compute bit for bit, and
``sums_in_launch_order`` adds such terms in the kernels' fixed order, so
that on the card every K1 launch's sums are that function of the plain
terms, bit for bit.

``gn_step`` / ``gn_step_reference`` run one damped Gauss-Newton iteration on
a state buffer that lives on the view's device (layout below): the normal
equations at the state's pose, the 6x6 solve, the convergence test and the
pose update, all frozen once the state is done or has run
``cfg.max_iterations`` steps. On the card the whole step is one kernel
launch and nothing is read back, so a level issues a fixed number of steps
and the host never waits inside a frame's tracking.

``slab_stepper`` splits that step around a collective, for the sharded
tracker (parallel.sharded): ``reduce`` sums one rank's slab of the queries
at the state's pose (one launch of K1's slab form), the caller all-reduces
the sums, and ``finish`` runs the solve, test and update on them (one
launch of ``gn_finish``, the one-warp code ``gn_step``'s kernel finishes
with). ``finisher`` is that finish alone: the central tracker's card path
against a dense grid packs its normal equations (``pack``) and finishes
them there too.

``central_stepper`` is K1's central form: the reference's 13-probe
Shepard-L1 Jacobian against the brick-major D and W rows, one launch a
step on the same state buffer, through the same reduce half and finish as
``gn_step`` (so its sums are ``sums_in_launch_order`` of
``central_terms_reference``'s terms bit for bit); its plain version is
``central_step_reference``.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from tracking_sdf_tpu_torch.config import GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.lie import Pose, se3_exp
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, BrickRows, MaskedView
from tracking_sdf_tpu_torch.kernels import _build

THREADS = 256  # queries per block; must match kThreads in gn_reduce.cu
N_OUT = 29

# The Gauss-Newton state of one level: (N_STATE,) float32. R row-major (9),
# t (3), the damping λ, the last twist (6), the valid count and Σ|r| of the
# last step; the last three slots hold int32 bits (read them through
# ``state.view(torch.int32)``): the steps run, the done flag and the
# kernel's block ticket (0 between launches). Must match gn_reduce.cu.
S_R, S_T, S_LAM, S_TWIST, S_NVALID, S_SUMABS = 0, 9, 12, 13, 19, 20
S_COUNT, S_DONE, S_TICKET = 21, 22, 23
N_STATE = 24

# kernel launches made on CUDA tensors, per entry point and form of the view
launches = 0  # gn_reduce, dense (m, m, m)
launches_brick = 0  # gn_reduce, brick-major rows
launches_slab = 0  # slab_stepper's reduce (K1's slab form), dense
launches_slab_brick = 0  # ... brick-major rows
launches_step = 0  # gn_step, dense
launches_step_brick = 0  # gn_step, brick-major rows
launches_finish = 0  # slab_stepper's finish (gn_finish)
launches_step_central = 0  # central_stepper (K1's central form), brick-major rows


@functools.lru_cache(maxsize=None)
def _triu(device):
    """Rows and columns of a 6x6 upper triangle, row-major (one constant
    tensor per device)."""
    return torch.triu_indices(6, 6, device=device)


@functools.lru_cache(maxsize=None)
def _triu_flat(device):
    """The same entries as indices into a flattened 6x6 matrix."""
    iu = _triu(device)
    return iu[0] * 6 + iu[1]


def unpack(out: torch.Tensor):
    """29 values -> (A (6, 6), b (6,), num_valid, sum_abs_residual)."""
    iu = _triu(out.device)
    A = torch.zeros(6, 6, dtype=out.dtype, device=out.device)
    A[iu[0], iu[1]] = out[:21]
    A[iu[1], iu[0]] = out[:21]
    return A, out[21:27], out[27], out[28]


def pack(A: torch.Tensor, b: torch.Tensor, num_valid: torch.Tensor,
         sum_abs: torch.Tensor) -> torch.Tensor:
    """(A (6, 6), b (6,), num_valid, sum_abs_residual) -> the 29 values
    ``unpack`` reads and ``gn_finish`` takes: A's upper triangle row-major,
    b, the count, Σ|r|. Device ops only (nothing is read by the host). Only
    the upper triangle travels, so an A that is not symmetric bit for bit
    (JᵀJ from a matmul may differ from its transpose in the last bit) comes
    back from ``unpack`` as its upper triangle mirrored."""
    return torch.cat([A.reshape(36).index_select(0, _triu_flat(A.device)), b.reshape(6),
                      num_valid.reshape(1), sum_abs.reshape(1)])


def _pose_of(pose) -> Pose:
    """A Pose, or the pose at the head of a GN state buffer."""
    return state_pose(pose) if torch.is_tensor(pose) else pose


def gn_reduce_reference(Dm: MaskedView, pose, points: torch.Tensor,
                        params: GridParams, i0: int = 0,
                        slab: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: pixel_residuals_analytic + normal_equations.

    Slab form (``i0`` and ``slab``; the plain version of slab_stepper's
    reduce): the view holds global planes [i0, i0 + mi) (one rank's slab
    and a halo), and a query counts only when the base floor(u) of its
    global i coordinate lies in [i0, i0 + slab); the slabs' sums then add up
    to the whole grid's."""
    # gauss_newton imports this module
    from tracking_sdf_tpu_torch.tracking.gauss_newton import (
        normal_equations, pixel_residuals_analytic)

    phi, J, mask = pixel_residuals_analytic(Dm, _pose_of(pose), points, params=params,
                                            i0=i0, slab=slab)
    A, b = normal_equations(phi, J, mask)
    return pack(A, b, mask.sum().to(torch.float32),
                torch.where(mask, phi.abs(), torch.zeros_like(phi)).sum())


def query_terms_reference(Dm: MaskedView, pose, points: torch.Tensor, params: GridParams,
                          i0: int = 0, slab: Optional[int] = None) -> torch.Tensor:
    """The plain version's (N, 29) terms of each query, in ``pack``'s
    layout: J_i J_j over A's upper triangle, J_i r, 1 and |r| for a valid
    query, zeros for any other. Their sum over queries is
    ``gn_reduce_reference``'s up to the order of the sums; on the card the
    kernel's per-query terms are these bit for bit. ``i0`` and ``slab`` as
    for ``gn_reduce_reference``."""
    from tracking_sdf_tpu_torch.tracking.gauss_newton import pixel_residuals_analytic

    return terms_of(*pixel_residuals_analytic(Dm, _pose_of(pose), points, params=params,
                                              i0=i0, slab=slab))


def terms_of(phi: torch.Tensor, J: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 29) terms of residuals phi (N,) and Jacobians J (N, 6) in
    ``pack``'s layout, zeros where not ``mask``."""
    iu = _triu(J.device)
    terms = torch.cat([J[:, iu[0]] * J[:, iu[1]], J * phi[:, None], torch.ones_like(phi)[:, None],
                       phi.abs()[:, None]], 1)
    return torch.where(mask[:, None], terms, torch.zeros_like(terms))


def central_terms_reference(rows: BrickRows, pose, points: torch.Tensor, params: GridParams,
                            cfg: TrackingConfig) -> torch.Tensor:
    """The plain (N, 29) terms of each query by the central scheme against
    the brick-major D and W rows (``pixel_residuals_central``'s 13 probes
    with ``cfg.v_h`` and ``cfg.w_h``), in ``pack``'s layout; on the card
    K1's central form computes them bit for bit."""
    from tracking_sdf_tpu_torch.tracking.gauss_newton import pixel_residuals_central

    return terms_of(*pixel_residuals_central(rows, _pose_of(pose), points, params=params,
                                             v_h=cfg.v_h, w_h=cfg.w_h))


def sums_in_launch_order(terms: torch.Tensor) -> torch.Tensor:
    """The (29,) sums of (N, 29) float32 per-query terms added in the order
    of one launch of K1 (``gn_reduce``, ``gn_step``, the slab form): the
    queries zero-padded to whole blocks of THREADS; in each warp of 32 the
    shuffle-down tree (lanes l and l + o added at o = 16, 8, 4, 2, 1); the
    block's warps in order from 0; lane j of 8 summing blocks j, j + 8, ...
    in order from 0; the 8 lanes in order from 0. Elementwise float32 adds
    only, so it gives the kernel's bits on any device (and zero-padding
    whole blocks to the lanes changes nothing: no partial sum is -0)."""
    n = terms.shape[0]
    blocks = max(-(-n // THREADS), 1)
    lanes = 8
    x = torch.zeros(-(-blocks // lanes) * lanes * THREADS, N_OUT, dtype=torch.float32,
                    device=terms.device)
    x[:n] = terms
    x = x.view(-1, THREADS // 32, 32, N_OUT)
    for o in (16, 8, 4, 2, 1):
        x = x[:, :, :o] + x[:, :, o:2 * o]
    warps = x[:, :, 0]  # (blocks, warps, 29)
    part = torch.zeros_like(warps[:, 0])
    for w in range(warps.shape[1]):
        part = part + warps[:, w]
    rounds = part.view(-1, lanes, N_OUT)
    lane = torch.zeros_like(rounds[0])
    for r in range(rounds.shape[0]):
        lane = lane + rounds[r]
    total = torch.zeros_like(lane[0])
    for j in range(lanes):
        total = total + lane[j]
    return total


def _view_args(Dm: MaskedView, params: GridParams, what: str):
    """Validate a CUDA view of (mi, m, m) voxels; (data, bf16, m, mi, bi, bj,
    bk, pitch) for the kernel."""
    m = params.m
    if isinstance(Dm, BrickMaskedView):
        data, (bi, bj, bk), pitch, mi = Dm.rows, Dm.bs, Dm.pitch, Dm.mi
        if (Dm.m != m or mi % bi or m % bj or m % bk or pitch < bi * bj * bk
                or data.numel() != (mi // bi) * (m // bj) * (m // bk) * pitch):
            raise ValueError(f"{what}: view rows {tuple(data.shape)} do not "
                             f"hold an ({mi}, {m}, {m}) grid of {Dm.bs} bricks at "
                             f"pitch {pitch}")
        dtypes = (torch.float32, torch.bfloat16)
    else:
        data, (bi, bj, bk), pitch, mi = Dm, (0, 0, 0), 0, Dm.shape[0]
        if Dm.dim() != 3 or tuple(Dm.shape[1:]) != (m, m):
            raise ValueError(f"{what}: Dm shape {tuple(Dm.shape)} != (mi, {m}, {m})")
        dtypes = (torch.float32,)
    if data.dtype not in dtypes or not data.is_contiguous():
        raise ValueError(f"{what}: the view must be contiguous {dtypes}, "
                         f"got {data.dtype}")
    return data, int(data.dtype == torch.bfloat16), m, mi, bi, bj, bk, pitch


def _grid_scale(params: GridParams):
    """origin (3) and voxels per meter (3), the kernels' world->voxel map."""
    return (*params.origin, params.m / params.width, params.m / params.height,
            params.m / params.depth)


def _slab_args(mi: int, m: int, i0: int, slab: Optional[int], what: str):
    """(i0, slab) of a view of ``mi`` planes, checked: an owned query's +1
    corner must lie in the view unless it is past the grid's last plane."""
    if slab is None:
        if i0 != 0 or mi != m:
            raise ValueError(f"{what}: a slab view ({mi} planes, i0={i0}) needs slab")
        return 0, m
    if i0 < 0 or slab < 1 or i0 + slab > m or mi < slab + (i0 + slab < m):
        raise ValueError(f"{what}: slab {slab} at i0={i0} does not fit the m={m} grid "
                         f"with a view of {mi} planes")
    return i0, slab


def gn_reducer(Dm: MaskedView, pose, points: torch.Tensor,
               params: GridParams) -> Callable[[], torch.Tensor]:
    """Validate CUDA inputs and allocate once; returns a function that
    launches the kernel on them and returns its (29,) output buffer: K1's
    slab form over the whole grid (i0 0, slab m) on a scratch state that
    holds the pose. ``pose``: a Pose or a GN state buffer (``init_state``),
    whose pose is copied into the scratch state here once."""
    dev = Dm.device
    if torch.is_tensor(pose):
        if (pose.dtype != torch.float32 or pose.device != dev
                or pose.numel() < S_LAM or not pose.is_contiguous()):
            raise ValueError(f"gn_reduce: a state pose must be a contiguous float32 "
                             f"buffer of at least {S_LAM} slots on {dev}")
        src = pose[:S_LAM]
    else:
        for name, x, shape in (("pose.R", pose.R, (3, 3)), ("pose.t", pose.t, (3,))):
            if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
                raise ValueError(f"gn_reduce: {name} must be float32 {shape} on {dev}")
        src = torch.cat([pose.R.reshape(9), pose.t])
    state = torch.zeros(N_STATE, dtype=torch.float32, device=dev)
    state[:S_LAM].copy_(src)
    # max_iterations 1: the scratch state runs no step, so it is never done
    return _slab_reducer(Dm, state, points, params, 1, 0, None,
                         "launches_brick" if isinstance(Dm, BrickMaskedView)
                         else "launches", "gn_reduce")


def gn_reduce(Dm: MaskedView, pose, points: torch.Tensor,
              params: GridParams) -> torch.Tensor:
    """Normal equations of the queries ``points`` (N, 3) (camera frame, NaN
    holes allowed) at ``pose`` (a Pose, or a GN state buffer) against the
    masked view ``Dm`` of the whole grid: a dense float32 (m, m, m) tensor
    or a BrickMaskedView of float32/bfloat16 rows.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if Dm.device.type == "cpu":
        return gn_reduce_reference(Dm, pose, points, params)
    if Dm.device.type != "cuda":
        raise ValueError(f"gn_reduce: unsupported device {Dm.device}")
    return gn_reducer(Dm, pose, points, params)()


# --- the Gauss-Newton step -------------------------------------------------

def init_state(pose: Pose, damping: float) -> torch.Tensor:
    """A fresh level state on the pose's device: the pose, λ = ``damping``,
    no steps run. Device ops only: nothing is copied from the host."""
    state = torch.zeros(N_STATE, dtype=torch.float32, device=pose.t.device)
    state[S_R:S_T].copy_(pose.R.reshape(9))
    state[S_T:S_LAM].copy_(pose.t)
    state[S_LAM].fill_(damping)
    return state


def state_pose(state: torch.Tensor) -> Pose:
    """The state's pose as views of the buffer."""
    return Pose(state[S_R:S_T].view(3, 3), state[S_T:S_LAM])


def apply_update(pose: Pose, twist: torch.Tensor, mode: str) -> Pose:
    e = se3_exp(twist)
    Ret = e.R.T
    if mode == "se3":
        # exact left-inverse composition: T <- exp(twist)^-1 ∘ T
        return Pose(Ret @ pose.R, Ret @ (pose.t - e.t))
    if mode == "reference":
        # the reference's quirk: t is not rotated
        return Pose(Ret @ pose.R, pose.t - Ret @ e.t)
    raise ValueError(f"unknown pose_update: {mode}")


def converged(twist: torch.Tensor, cfg: TrackingConfig) -> torch.Tensor:
    if cfg.convergence == "norm":
        return twist.abs().max() < cfg.max_twist_diff
    if cfg.convergence == "signed":
        # the reference's quirk: a signed comparison
        return (twist < cfg.max_twist_diff).all()
    raise ValueError(f"unknown convergence mode: {cfg.convergence}")


def level_active(state: torch.Tensor, cfg: TrackingConfig) -> torch.Tensor:
    """The state is neither done nor at ``cfg.max_iterations`` steps (a
    0-dim bool on its device)."""
    ints = state.view(torch.int32)
    return (ints[S_DONE] == 0) & (ints[S_COUNT] < cfg.max_iterations)


def advance_state(state: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                  nvalid: torch.Tensor, sum_abs: torch.Tensor, cfg: TrackingConfig) -> None:
    """One Gauss-Newton iteration on ``state`` in place from the normal
    equations A (6, 6), b (6,), the valid count and Σ|r| at its pose: the
    damped solve, the convergence test and the pose update, frozen once the
    state is done or has run ``cfg.max_iterations`` steps. Every Jacobian
    scheme advances its state here (the card's ``gn_step`` and ``gn_finish``
    do the same inside their kernels)."""
    ints = state.view(torch.int32)
    active = level_active(state, cfg)
    pose = state_pose(state)
    lam = state[S_LAM]
    # Marquardt damping plus a tiny floor that keeps a degenerate system
    # solvable; a non-finite solve (singular system) takes no step
    A = A + lam * torch.diag(torch.diag(A)) + 1e-12 * torch.eye(6, device=A.device)
    twist = torch.linalg.solve_ex(A, b)[0]
    twist = torch.where(torch.isfinite(twist).all(), twist, torch.zeros_like(twist))
    count = ints[S_COUNT]
    done = converged(twist, cfg) & (count + 1 >= cfg.min_iterations)
    # the reference updates the pose on the converging iteration too
    new = apply_update(pose, twist, cfg.pose_update)
    f_new = torch.cat([new.R.reshape(9), new.t, (lam * cfg.damping_decay)[None],
                       twist, nvalid[None], sum_abs[None]])
    i_new = torch.stack([count + 1, done.to(torch.int32), torch.zeros_like(count)])
    state[:S_COUNT] = torch.where(active, f_new, state[:S_COUNT])
    ints[S_COUNT:] = torch.where(active, i_new, ints[S_COUNT:])


def gn_step_reference(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
                      params: GridParams, cfg: TrackingConfig) -> None:
    """Plain PyTorch version of ``gn_step``; updates ``state`` in place.
    ``points``: (N, 3) or an (h, w, 3) view of camera-frame points."""
    advance_state(state, *unpack(gn_reduce_reference(
        Dm, state_pose(state), points.reshape(-1, 3), params)), cfg)


def gn_reduce_slab_reference(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
                             params: GridParams, cfg: TrackingConfig, i0: int = 0,
                             slab: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of slab_stepper's reduce: the (29,) slab sums
    at the state's pose, zeros once the level is done (so that an in-place
    all_reduce of them stays zeros)."""
    out = gn_reduce_reference(Dm, state_pose(state), points.reshape(-1, 3), params,
                              i0=i0, slab=slab)
    return torch.where(level_active(state, cfg), out, torch.zeros_like(out))


def central_step_reference(rows: BrickRows, state: torch.Tensor, points: torch.Tensor,
                           params: GridParams, cfg: TrackingConfig) -> None:
    """Plain version of ``central_stepper``'s step; updates ``state`` in
    place: the central terms of the queries at the state's pose
    (``central_terms_reference``), added in K1's launch order
    (``sums_in_launch_order``), then the finish (``finisher``: on a CPU
    state ``advance_state``, on the card the one ``gn_finish`` launch that
    K1's kernels end in, so that there it leaves the kernel's state bit for
    bit). ``points``: (N, 3) or an (h, w, 3) view."""
    finisher(state, cfg)(sums_in_launch_order(central_terms_reference(
        rows, state, points.reshape(-1, 3), params, cfg)))


def _central_inverse_spans(params: GridParams, cfg: TrackingConfig):
    """float32(1 / h_c) of the central Jacobian's six probe spans
    (``gauss_newton.central_spans``), as the card divides by the Python
    floats h_c in pixel_residuals_central."""
    from tracking_sdf_tpu_torch.tracking.gauss_newton import central_spans

    return tuple(_build.card_reciprocal(h) for h in central_spans(params, cfg.v_h, cfg.w_h))


def central_stepper(rows: BrickRows, state: torch.Tensor, points: torch.Tensor,
                    params: GridParams, cfg: TrackingConfig) -> Callable[[], None]:
    """One level of central-difference Gauss-Newton against the brick-major
    D and W rows of the whole grid, validated and allocated once: returns a
    function that runs one step on ``state`` per call (frozen once it is
    done or has run ``cfg.max_iterations`` steps). ``points`` as for
    ``gn_stepper``.

    CPU tensors take ``central_step_reference``. On CUDA tensors each call
    is one launch of K1's central form (``gn_central_step_kernel``,
    ``launches_step_central``) on the current stream, nothing read by the
    host: each query's 13 Shepard-L1 probes read the D and W rows in place,
    its terms are ``central_terms_reference``'s bit for bit, and they are
    summed and finished as ``gn_step`` sums and finishes its own."""
    _check_modes(cfg)
    D, W = rows
    if D.device.type == "cpu":
        return lambda: central_step_reference(rows, state, points, params, cfg)
    if D.device.type != "cuda":
        raise ValueError(f"central_step: unsupported device {D.device}")
    if not (isinstance(D, BrickMaskedView) and isinstance(W, BrickMaskedView)
            and W.bs == D.bs and W.pitch == D.pitch and D.mi == W.mi == params.m):
        raise ValueError("central_step: D and W must be brick-major rows of the whole grid "
                         "in one layout")
    view, pts, dev = _step_args(D, state, points, params, "central_step")
    wview = _view_args(W, params, "central_step")
    if W.device != dev:
        raise ValueError(f"central_step: W on {W.device}, D on {dev}")
    blocks, partials = _partials(pts[1], dev)
    lib = _build.library()
    args = (view[0].data_ptr(), wview[0].data_ptr(), view[1], wview[1], view[2], *view[4:],
            *pts, *_grid_scale(params), cfg.v_h, cfg.w_h, *_central_inverse_spans(params, cfg),
            partials.data_ptr(), blocks, state.data_ptr(), *_step_cfg(cfg))

    def step() -> None:
        global launches_step_central
        _build.check(lib.tsdf_gn_central_step(*args, _build.stream_ptr(dev)), "central_step")
        launches_step_central += 1

    # the kernel reads and writes these through the pointers in ``args``
    step.buffers = (partials, points, state, view[0], wview[0])
    return step


def _check_modes(cfg: TrackingConfig) -> None:
    if cfg.convergence not in ("norm", "signed"):
        raise ValueError(f"unknown convergence mode: {cfg.convergence}")
    if cfg.pose_update not in ("se3", "reference"):
        raise ValueError(f"unknown pose_update: {cfg.pose_update}")


def _step_cfg(cfg: TrackingConfig):
    """The kernels' step settings: max_iterations, min_iterations,
    signed_conv, reference_update, max_twist_diff, damping_decay."""
    return (cfg.max_iterations, cfg.min_iterations, int(cfg.convergence == "signed"),
            int(cfg.pose_update == "reference"), cfg.max_twist_diff, cfg.damping_decay)


def _step_args(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
               params: GridParams, what: str):
    """Validate a CUDA level's inputs; (view args, point args (ptr, n, w, sh,
    sw), device) for the kernels."""
    view = _view_args(Dm, params, what)
    dev = view[0].device
    if (state.dtype != torch.float32 or tuple(state.shape) != (N_STATE,)
            or state.device != dev or not state.is_contiguous()):
        raise ValueError(f"{what}: state must be contiguous float32 ({N_STATE},) on {dev}")
    if (points.dtype != torch.float32 or points.device != dev
            or points.dim() not in (2, 3) or points.shape[-1] != 3
            or points.stride(-1) != 1):
        raise ValueError(f"{what}: points must be float32 (N, 3) or (h, w, 3) on "
                         f"{dev} with unit stride along the last axis, got "
                         f"{tuple(points.shape)} {points.dtype} {points.device}")
    if points.dim() == 2:
        h, w, sh, sw = points.shape[0], 1, points.stride(0), 0
    else:
        h, w, sh, sw = (*points.shape[:2], *points.stride()[:2])
    return view, (points.data_ptr(), h * w, w, sh, sw), dev


def _partials(n: int, dev):
    """(blocks, scratch) of a launch over n queries."""
    blocks = max(-(-n // THREADS), 1)
    return blocks, torch.empty(blocks * N_OUT, dtype=torch.float32, device=dev)


def _slab_reducer(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
                  params: GridParams, max_iterations: int, i0: int, slab: Optional[int],
                  counter: str, what: str) -> Callable[[], torch.Tensor]:
    """K1's slab form on CUDA inputs, validated and allocated once: each call
    is one launch that returns the (29,) sums at the state's pose (zeros once
    the level is done) and adds one to the module counter ``counter``."""
    view, pts, dev = _step_args(Dm, state, points, params, what)
    i0, slab_n = _slab_args(view[3], params.m, i0, slab, what)
    blocks, partials = _partials(pts[1], dev)
    out = torch.empty(N_OUT, dtype=torch.float32, device=dev)
    lib = _build.library()
    args = (view[0].data_ptr(), view[1], view[2], view[3], i0, slab_n, *view[4:], *pts,
            *_grid_scale(params), partials.data_ptr(), blocks, state.data_ptr(),
            max_iterations, out.data_ptr())

    def reduce() -> torch.Tensor:
        _build.check(lib.tsdf_gn_reduce_slab(*args, _build.stream_ptr(dev)), what)
        globals()[counter] += 1
        return out

    # the kernel reads and writes these through the pointers in ``args``
    reduce.buffers = (partials, points, state, view[0], out)
    return reduce


def gn_stepper(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
               params: GridParams, cfg: TrackingConfig) -> Callable[[], None]:
    """Validate one level's inputs and allocate its scratch once; returns a
    function that runs one step on ``state`` per call.

    ``points``: (N, 3) or (h, w, 3) float32 camera-frame points, NaN holes
    allowed, with unit stride along the last axis; the kernel reads a
    strided view such as ``points_img[::s, ::s]`` in place (query q is
    element (q // w, q % w)). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_modes(cfg)
    if Dm.device.type == "cpu":
        flat = points.reshape(-1, 3)
        return lambda: gn_step_reference(Dm, state, flat, params, cfg)
    if Dm.device.type != "cuda":
        raise ValueError(f"gn_step: unsupported device {Dm.device}")
    view, pts, dev = _step_args(Dm, state, points, params, "gn_step")
    if view[3] != params.m:
        raise ValueError("gn_step: the view must hold the whole grid (no slab form)")
    blocks, partials = _partials(pts[1], dev)
    lib = _build.library()
    args = (view[0].data_ptr(), *view[1:3], *view[4:], *pts, *_grid_scale(params),
            partials.data_ptr(), blocks, state.data_ptr(), *_step_cfg(cfg))
    brick = isinstance(Dm, BrickMaskedView)

    def step() -> None:
        global launches_step, launches_step_brick
        _build.check(lib.tsdf_gn_step(*args, _build.stream_ptr(dev)), "gn_step")
        if brick:
            launches_step_brick += 1
        else:
            launches_step += 1

    # the kernel reads and writes these through the pointers in ``args``
    step.buffers = (partials, points, state, view[0])
    return step


def gn_step(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
            params: GridParams, cfg: TrackingConfig) -> None:
    """One Gauss-Newton step on ``state`` in place (a no-op once the state
    is done or has run ``cfg.max_iterations`` steps). A loop over steps
    should build ``gn_stepper`` once instead: this validates and allocates
    on every call."""
    gn_stepper(Dm, state, points, params, cfg)()


def slab_stepper(Dm: MaskedView, state: torch.Tensor, points: torch.Tensor,
                 params: GridParams, cfg: TrackingConfig, *, i0: int = 0,
                 slab: Optional[int] = None):
    """One rank's Gauss-Newton step around a collective, validated and
    allocated once: returns ``(reduce, finish)``.

    ``reduce()`` returns the (29,) sums of this rank's queries at the
    state's pose (K1's slab form: ``Dm`` holds global planes [i0, i0 + mi),
    a query counts when its base plane lies in [i0, i0 + slab); zeros once
    the level is done); the caller sums them over the ranks in place;
    ``finish(sums)`` runs the damped solve, the convergence test and the
    pose update on ``state`` from the summed equations, frozen once the
    level is done. Every rank that finishes the same sums holds the same
    state bit for bit. ``points`` as for ``gn_stepper``.

    CPU tensors take the plain versions (``gn_reduce_slab_reference`` and
    ``advance_state``); on CUDA tensors each call is one kernel launch
    (``launches_slab`` / ``launches_slab_brick``, ``launches_finish``), on
    the current stream, with nothing read by the host. On one rank with the
    whole grid (i0 0, slab m or None) reduce, then finish, is one
    ``gn_step`` launch bit for bit."""
    _check_modes(cfg)
    if Dm.device.type == "cpu":
        flat = points.reshape(-1, 3)

        def reduce_plain() -> torch.Tensor:
            return gn_reduce_slab_reference(Dm, state, flat, params, cfg, i0=i0,
                                            slab=slab)

        return reduce_plain, finisher(state, cfg)
    if Dm.device.type != "cuda":
        raise ValueError(f"slab_stepper: unsupported device {Dm.device}")
    reduce = _slab_reducer(Dm, state, points, params, cfg.max_iterations, i0, slab,
                           "launches_slab_brick" if isinstance(Dm, BrickMaskedView)
                           else "launches_slab", "slab_stepper")
    return reduce, finisher(state, cfg)


def finisher(state: torch.Tensor, cfg: TrackingConfig) -> Callable[[torch.Tensor], None]:
    """The rest of a Gauss-Newton step on ``state`` from its 29 summed
    normal equations (``pack``'s layout), validated once: returns
    ``finish(sums)``, which runs the damped solve, the convergence test and
    the pose update in place, frozen once the level is done.

    On a CPU state it is the plain version, ``advance_state`` on
    ``unpack(sums)``. On a CUDA state each call is one launch of
    ``gn_finish`` (``launches_finish``) on the current stream, nothing read
    by the host; the sums must be contiguous float32 on the state's device.
    With no kernel library the card raises (there is no CPU fallback)."""
    _check_modes(cfg)
    dev = state.device
    if dev.type == "cpu":
        def finish_plain(sums: torch.Tensor) -> None:
            advance_state(state, *unpack(sums), cfg)

        return finish_plain
    if dev.type != "cuda":
        raise ValueError(f"gn_finish: unsupported device {dev}")
    if (state.dtype != torch.float32 or tuple(state.shape) != (N_STATE,)
            or not state.is_contiguous()):
        raise ValueError(f"gn_finish: state must be contiguous float32 ({N_STATE},)")
    lib = _build.library()
    step_cfg = _step_cfg(cfg)

    def finish(sums: torch.Tensor) -> None:
        global launches_finish
        if (sums.dtype != torch.float32 or sums.device != dev or sums.numel() != N_OUT
                or not sums.is_contiguous()):
            raise ValueError(f"gn_finish: sums must be contiguous float32 ({N_OUT},) "
                             f"on {dev}")
        _build.check(lib.tsdf_gn_finish(sums.data_ptr(), state.data_ptr(), *step_cfg,
                                        _build.stream_ptr(dev)), "gn_finish")
        launches_finish += 1

    return finish
