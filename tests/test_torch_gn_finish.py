"""The sharded Gauss-Newton step split around its all_reduce
(``gn_reduce.slab_stepper``) on the CPU, where it takes its plain versions:
the slab sums (``gn_reduce_slab_reference``) and ``advance_state``.

The inputs are numpy arrays from a seed: a sphere + box SDF at m = 48 with a
tenth of its voxels unobserved, as a dense masked view and as brick-major
float32 rows, and points on the shapes. Checks, all bit for bit:
  * on one rank with the whole grid, reduce then finish is one step of
    ``gn_step_reference`` (the plain counterpart of the card's gate: one
    slab iteration equal to one ``gn_step`` launch);
  * n ranks' slab steppers whose sums are added are n copies of one state,
    the state of the step on the whole grid's sums added in rank order;
  * once the level is done (converged, or at ``max_iterations``), reduce
    returns zeros, so that an in-place all_reduce of them stays zeros, and
    finish leaves the state unchanged.
The agreement with the JAX package's sharded trackers is held in
tests/test_torch_parallel.py.
"""
import numpy as np
import pytest
import torch

from tracking_sdf_tpu_torch.config import GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.lie import se3_exp
from tracking_sdf_tpu_torch.fusion.brickmajor import brick_grid_from_dense, brick_masked_view
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, masked_view
from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

torch.set_num_threads(2)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
BS = (4, 8, 8)  # whole brick layers per slab at n = 1, 2, 4


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _scene(form):
    """(the whole grid's view, points (N, 3) on its surfaces, a start pose
    near the identity, where they lie) from seed 0."""
    rng = np.random.default_rng(0)
    m = PARAMS.m
    c = (np.arange(m) + 0.5) * PARAMS.width / m - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    sphere = np.sqrt((x - 0.1) ** 2 + (y - 0.05) ** 2 + z ** 2) - 0.45
    q = np.abs(np.stack([x + 0.55, y, z + 0.2], -1)) - np.array([0.2, 0.4, 0.35])
    box = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
           + np.minimum(q.max(axis=-1), 0.0))
    D = torch.from_numpy(np.minimum(sphere, box).astype(np.float32))
    W = torch.from_numpy((rng.random((m, m, m)) >= 0.1).astype(np.float32))
    # points on the two surfaces (the sphere alone leaves rotations about
    # its centre unobservable), some of them holes
    dirs = rng.normal(size=(2000, 3))
    on_sphere = np.array([0.1, 0.05, 0.0]) + 0.45 * dirs / np.linalg.norm(
        dirs, axis=1, keepdims=True)
    u = rng.uniform(-1.0, 1.0, (1000, 3))
    u[np.arange(1000), rng.integers(0, 3, 1000)] = rng.choice([-1.0, 1.0], 1000)
    on_box = np.array([-0.55, 0.0, -0.2]) + u * np.array([0.2, 0.4, 0.35])
    pts = torch.from_numpy(np.concatenate([on_sphere, on_box]).astype(np.float32))
    pts[::17] = float("nan")
    pose = se3_exp(torch.tensor([0.01, -0.02, 0.015, 0.03, -0.02, 0.01]))
    if form == "dense":
        return masked_view(D, W).contiguous(), pts, pose
    dense = TSDFGrid(D=D, W=W, R=D, G=D, B=D, Wc=W)
    return brick_masked_view(brick_grid_from_dense(dense, BS), PARAMS, BS), pts, pose


def _slab_views(view, n):
    """Rank r's slab of ``view`` and its halo (the next rank's first plane or
    brick layer, NaN past the last rank)."""
    m, s = PARAMS.m, PARAMS.m // n
    if not isinstance(view, BrickMaskedView):
        nan = torch.full((1, m, m), float("nan"))
        return [torch.cat([view[r * s:(r + 1) * s],
                           view[(r + 1) * s:(r + 1) * s + 1] if r < n - 1 else nan])
                for r in range(n)]
    rows = view.rows
    per, layer = rows.shape[0] // n, (m // BS[1]) * (m // BS[2])
    nan = torch.full((layer, rows.shape[1]), float("nan"))
    return [BrickMaskedView(torch.cat([rows[r * per:(r + 1) * per],
                                       rows[(r + 1) * per:(r + 1) * per + layer]
                                       if r < n - 1 else nan]), m, BS, mi=s + BS[0])
            for r in range(n)]


@pytest.mark.parametrize("form", ["dense", "brick"])
def test_one_rank_whole_grid_iteration_is_the_plain_step(form):
    """reduce -> (identity all_reduce) -> finish on the whole grid is one
    gn_step_reference step, iteration by iteration over a level."""
    view, pts, pose = _scene(form)
    cfg = TrackingConfig(max_iterations=6)
    state, ref = k1.init_state(pose, cfg.damping), k1.init_state(pose, cfg.damping)
    reduce, finish = k1.slab_stepper(view, state, pts, PARAMS, cfg)
    launches = (k1.launches_slab, k1.launches_slab_brick, k1.launches_finish)
    for _ in range(cfg.max_iterations):
        finish(reduce())
        k1.gn_step_reference(view, ref, pts, PARAMS, cfg)
        assert torch.equal(_bits(state), _bits(ref))
    assert (k1.launches_slab, k1.launches_slab_brick, k1.launches_finish) == launches
    assert int(_bits(state)[k1.S_COUNT]) > 1 and float(state[k1.S_NVALID]) > 500


@pytest.mark.parametrize("form", ["dense", "brick"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_slab_steppers_are_one_state(form, n):
    """n ranks' steppers, their sums added in rank order before every
    finish, all hold the state of the plain step on the same added sums;
    the slabs' valid counts add up to the whole grid's."""
    view, pts, pose = _scene(form)
    cfg = TrackingConfig(max_iterations=8)
    s = PARAMS.m // n
    states = [k1.init_state(pose, cfg.damping) for _ in range(n)]
    steppers = [k1.slab_stepper(v, states[r], pts, PARAMS, cfg, i0=r * s, slab=s)
                for r, v in enumerate(_slab_views(view, n))]
    ref = k1.init_state(pose, cfg.damping)
    for it in range(cfg.max_iterations):
        parts = [reduce() for reduce, _ in steppers]
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        if it == 0:
            whole = k1.gn_reduce_reference(view, pose, pts, PARAMS)
            assert int(total[27]) == int(whole[27]) > 500
        k1.advance_state(ref, *k1.unpack(total), cfg)
        for _, finish in steppers:
            finish(total)
    for st in states:
        assert torch.equal(_bits(st), _bits(ref))


@pytest.mark.parametrize("limit", ["converged", "max_iterations"])
def test_done_level_zeroes_the_sums_and_freezes_the_state(limit):
    """Once the level is done, reduce returns zeros (two ranks' in-place sum
    of them stays zeros) and finish leaves the state bit for bit."""
    view, pts, pose = _scene("brick")
    if limit == "converged":
        cfg = TrackingConfig(max_iterations=50, max_twist_diff=1e-3)
    else:
        cfg = TrackingConfig(max_iterations=2, max_twist_diff=-1.0, min_iterations=0)
    n, s = 2, PARAMS.m // 2
    states = [k1.init_state(pose, cfg.damping) for _ in range(n)]
    steppers = [k1.slab_stepper(v, states[r], pts, PARAMS, cfg, i0=r * s, slab=s)
                for r, v in enumerate(_slab_views(view, n))]
    for _ in range(cfg.max_iterations):
        total = steppers[0][0]() + steppers[1][0]()
        for _, finish in steppers:
            finish(total)
    ints = _bits(states[0])
    if limit == "converged":
        assert int(ints[k1.S_DONE]) == 1 and int(ints[k1.S_COUNT]) < cfg.max_iterations
    else:
        assert int(ints[k1.S_DONE]) == 0 and int(ints[k1.S_COUNT]) == cfg.max_iterations
    frozen = [st.clone() for st in states]
    for _ in range(3):
        sums = [reduce() for reduce, _ in steppers]
        assert all(torch.equal(x, torch.zeros(k1.N_OUT)) for x in sums)
        total = sums[0]
        total += sums[1]  # the in-place all_reduce of a done iteration
        assert torch.equal(total, torch.zeros(k1.N_OUT))
        for _, finish in steppers:
            finish(total)
        # a finish fed stale sums writes nothing either
        steppers[0][1](torch.ones(k1.N_OUT))
    for st, fr in zip(states, frozen):
        assert torch.equal(_bits(st), _bits(fr))


@pytest.mark.parametrize("field,value", [("convergence", "max"),
                                         ("pose_update", "left")])
def test_slab_stepper_rejects_unknown_modes(field, value):
    view, pts, pose = _scene("dense")
    cfg = TrackingConfig()._replace(**{field: value})
    with pytest.raises(ValueError):
        k1.slab_stepper(view, k1.init_state(pose, cfg.damping), pts, PARAMS, cfg)



@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpack_of_pack_is_the_inputs(seed):
    """``unpack(pack(A, b, n, s))`` gives back a symmetric A, b, the count
    and Σ|r| bit for bit (NaN, ±inf and -0 entries included), and ``pack``
    lays them out as ``gn_reduce_reference`` does."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(6, 6)).astype(np.float32)
    A = torch.from_numpy(X + X.T)
    A[0, 0], A[1, 2], A[2, 1] = -0.0, float("nan"), float("nan")
    A[3, 5] = A[5, 3] = float("inf") if seed else -float("inf")
    b = torch.from_numpy(rng.normal(size=6).astype(np.float32))
    b[4] = -0.0
    n, s = torch.tensor(float(rng.integers(0, 5000))), torch.tensor(float(rng.random()))
    sums = k1.pack(A, b, n, s)
    assert sums.shape == (k1.N_OUT,) and sums.dtype == torch.float32
    back = k1.unpack(sums)
    for got, want in zip(back, (A, b, n, s)):
        assert torch.equal(_bits(got), _bits(want))
    view, pts, pose = _scene("dense")
    out = k1.gn_reduce_reference(view, pose, pts, PARAMS)
    assert torch.equal(_bits(k1.pack(*k1.unpack(out))), _bits(out))


def test_finisher_on_the_cpu_is_advance_state_and_builds_nothing(monkeypatch):
    """On a CPU state the finisher is ``advance_state`` on ``unpack`` (bit
    for bit) and never reaches the kernel library; an unknown device or mode
    raises."""
    from tracking_sdf_tpu_torch.kernels import _build

    def no_build():
        raise AssertionError("the CPU finisher reached the kernel library")

    monkeypatch.setattr(_build, "library", no_build)
    view, pts, pose = _scene("brick")
    cfg = TrackingConfig(max_iterations=5)
    sums = k1.gn_reduce_reference(view, pose, pts, PARAMS)
    state, ref = k1.init_state(pose, cfg.damping), k1.init_state(pose, cfg.damping)
    before = k1.launches_finish
    k1.finisher(state, cfg)(sums)
    k1.advance_state(ref, *k1.unpack(sums), cfg)
    assert torch.equal(_bits(state), _bits(ref)) and k1.launches_finish == before
    assert int(_bits(state)[k1.S_COUNT]) == 1
    with pytest.raises(ValueError):
        k1.finisher(state, cfg._replace(convergence="max"))
    with pytest.raises(ValueError):
        k1.finisher(state.to("meta"), cfg)
