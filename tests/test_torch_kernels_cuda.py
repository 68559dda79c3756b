"""The port's CUDA kernels against their plain versions, on a CUDA GPU.

Marked ``cuda``: each test skips without a card (decided inside the test, so
every pytest-xdist worker collects the same tests). On a GPU machine run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
Tolerances: K1 relative 1e-4 of max|A| and max|b| against the plain
reduction (float32 sums in another order), and bitwise against the plain
per-query terms summed in K1's launch order (gn_reduce.sums_in_launch_order:
gn_reduce, the slab form and gn_step through gn_finish), K1's step
relative 1e-4 of max|twist| with equal valid counts, step
counts and done flags (the kernel solves in float64, the plain step in
float32; the same bars hold gn_finish against advance_state, and the
central tracker on a dense grid on the card, whose every iteration is one
gn_finish launch, against its CPU path), K1's central form (the 13-probe central
Jacobian on tum256central's 256^3 bf16 D and W rows) bitwise against its
plain version over a level at three poses, one that drops queries at the
grid's face, and tum256central's chunk replays bitwise its per-frame loop,
the sharded
step's slab reduce and finish on one rank's whole grid bitwise against
gn_step (the same per-query code, partial order and finish), K2's dense
form, its row form and its fused form (brick_fuse_rows) bitwise on every
stored non-NaN value with equal NaN masks (the kernels round each step as
PyTorch's eager ops do), K3's filters (both forms; the separable one in
one launch and each one-axis mode) and K4 (points and normals, from depth
and from points) bitwise with equal NaN masks, K3's and K4's compiled radii
bitwise their runtime-radius code at radii 0-5, and preprocess_frame
captured in a CUDA graph bitwise against the eager call.
"""
import pytest
import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import se3_exp
from tracking_sdf_tpu_torch.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu_torch.fusion import brick_fuse
from tracking_sdf_tpu_torch.fusion import brick_merge as k2
from tracking_sdf_tpu_torch.fusion.brick import _pixel_table
from tracking_sdf_tpu_torch.fusion.brickmajor import (
    brick_grid_from_dense, brick_masked_view, classify_compact_rows, color_lane_widths,
    pack_color)
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid
from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

pytestmark = pytest.mark.cuda

PARAMS = GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _sphere_view(dev, gen):
    """A sphere SDF with 10% of the voxels unobserved (NaN), queries and a pose."""
    m = PARAMS.m
    idx = torch.arange(m, device=dev, dtype=torch.float32)
    x = (idx[:, None, None] + 0.5) * PARAMS.width / m + PARAMS.origin[0]
    y = (idx[None, :, None] + 0.5) * PARAMS.height / m + PARAMS.origin[1]
    z = (idx[None, None, :] + 0.5) * PARAMS.depth / m + PARAMS.origin[2]
    D = torch.sqrt(x * x + y * y + z * z) - 0.5
    W = (torch.rand(D.shape, generator=gen, device=dev) >= 0.1).to(torch.float32)
    pts = torch.randn(5000, 3, generator=gen, device=dev) * 0.4
    pts[::17] = float("nan")
    pose = se3_exp(torch.tensor([0.01, -0.02, 0.03, 0.05, -0.02, 0.01], device=dev))
    return D, W, pts, pose


def _check_gn(out, ref):
    assert out[27].item() == ref[27].item() > 100
    for sl in (slice(0, 21), slice(21, 27)):
        err = (out[sl] - ref[sl]).abs().max() / ref[sl].abs().max()
        assert err.item() <= 1e-4


def test_gn_reduce_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    D, W, pts, pose = _sphere_view(dev, gen)
    Dm = torch.where(W > 0, D, torch.full_like(D, float("nan"))).contiguous()
    before = k1.launches
    out = k1.gn_reduce(Dm, pose, pts, PARAMS)
    ref = k1.gn_reduce_reference(Dm, pose, pts, PARAMS)
    assert k1.launches == before + 1
    _check_gn(out, ref)
    # the pose read from a GN state buffer: the same kernel on the same bits
    state = k1.init_state(pose, 0.5)
    assert torch.equal(k1.gn_reduce(Dm, state, pts, PARAMS), out)
    assert k1.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_reduce_brick_kernel_matches_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(2)
    D, W, pts, pose = _sphere_view(dev, gen)
    dense = TSDFGrid(D=D, W=W, R=D, G=D, B=D, Wc=W)
    view = brick_masked_view(brick_grid_from_dense(dense, (8, 8, 8), dtype, dtype),
                             PARAMS, (8, 8, 8))
    before = (k1.launches, k1.launches_brick)
    out = k1.gn_reduce(view, pose, pts, PARAMS)
    ref = k1.gn_reduce_reference(view, pose, pts, PARAMS)
    assert (k1.launches, k1.launches_brick) == (before[0], before[1] + 1)
    _check_gn(out, ref)


def test_gn_reduce_rejects_bad_input(dev):
    Dm = torch.zeros(PARAMS.m, PARAMS.m, PARAMS.m, device=dev)
    pose = se3_exp(torch.zeros(6, device=dev))
    with pytest.raises(ValueError):
        k1.gn_reduce(Dm, pose, torch.zeros(10, 3, device=dev, dtype=torch.float64), PARAMS)
    with pytest.raises(ValueError):
        k1.gn_reduce(Dm[:, :, :32], pose, torch.zeros(10, 3, device=dev), PARAMS)


def _sphere_box(dev):
    """(D, W, pts, pose): the sphere joined by a box. A lone sphere leaves
    rotations about its centre unobservable, and the twist of such a system
    is set by rounding."""
    gen = torch.Generator(device=dev).manual_seed(4)
    D, W, pts, pose = _sphere_view(dev, gen)
    m = PARAMS.m
    c = (torch.arange(m, device=dev, dtype=torch.float32) + 0.5) * PARAMS.width / m - 1.0
    q = torch.stack(torch.meshgrid(c - 0.45, c + 0.3, c - 0.1, indexing="ij"), -1).abs()
    q = q - torch.tensor([0.2, 0.35, 0.15], device=dev)
    box = q.clamp(min=0).norm(dim=-1) + q.max(dim=-1).values.clamp(max=0)
    return torch.minimum(D, box), W, pts, pose


def _surface_points(dev, pose):
    """Camera-frame points on ``_sphere_box``'s surface seen from ``pose``
    (the sphere outside the box and the box outside the sphere), from a
    seed."""
    gen = torch.Generator(device=dev).manual_seed(5)
    center = torch.tensor([0.45, -0.3, 0.1], device=dev)
    half = torch.tensor([0.2, 0.35, 0.15], device=dev)

    def box_sdf(p):
        q = (p - center).abs() - half
        return q.clamp(min=0).norm(dim=-1) + q.max(dim=-1).values.clamp(max=0)

    dirs = torch.randn(2000, 3, generator=gen, device=dev)
    sphere = 0.5 * dirs / dirs.norm(dim=1, keepdim=True)
    u = torch.rand(1000, 3, generator=gen, device=dev) * 2 - 1
    face = torch.randint(0, 3, (1000,), generator=gen, device=dev)
    u[torch.arange(1000, device=dev), face] = torch.where(
        torch.rand(1000, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    box = center + u * half
    world = torch.cat([sphere[box_sdf(sphere) >= 0], box[box.norm(dim=-1) >= 0.5]])
    return (world - pose.t) @ pose.R


def _step_view(dev, form):
    """``_sphere_box``'s masked view as ``form``, its points and pose."""
    D, W, pts, pose = _sphere_box(dev)
    if form == "dense":
        return torch.where(W > 0, D, torch.full_like(D, float("nan"))).contiguous(), pts, pose
    dtype = torch.bfloat16 if form == "brick_bf16" else torch.float32
    dense = TSDFGrid(D=D, W=W, R=D, G=D, B=D, Wc=W)
    view = brick_masked_view(brick_grid_from_dense(dense, (8, 8, 8), dtype, dtype),
                             PARAMS, (8, 8, 8))
    return view, pts, pose


@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_query_terms_are_the_plain_terms_bitwise(dev, form):
    """K1 on one query at a time: its 27 terms, valid count and |r| are the
    plain version's per-query J_i J_j, J_i r and |r| bit for bit (the kernel
    rounds each step as the eager ops do), so K1 and its plain version
    differ only in the order of the sums over queries."""
    view, pts, pose = _step_view(dev, form)
    terms = k1.query_terms_reference(view, pose, pts, PARAMS)
    idx = (terms[:, 27] == 1).nonzero().flatten()[:300]
    assert idx.numel() == 300
    want = terms[idx]
    got = torch.stack([k1.gn_reduce(view, pose, pts[i:i + 1], PARAMS) for i in idx.tolist()])
    # equal values (the launch sums the query's terms with the other lanes'
    # zeros, which turns a -0 term into +0)
    differ = (got != want).any(1)
    assert not bool(differ.any()), (int(differ.sum()), got[differ][:2], want[differ][:2])


@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_step_kernel_matches_plain(dev, form):
    """Three steps, each from the state the kernel left, kernel and plain,
    through an (h, w, 3) strided view of the points."""
    view, pts, pose = _step_view(dev, form)
    img = pts.reshape(50, 100, 3)[::2, ::1]
    cfg = TrackingConfig(max_iterations=3)
    sk = k1.init_state(pose, cfg.damping)
    sr = torch.empty_like(sk)
    step = k1.gn_stepper(view, sk, img, PARAMS, cfg)
    counts = (k1.launches_step, k1.launches_step_brick)
    for i in range(3):
        sr.copy_(sk)
        step()
        k1.gn_step_reference(view, sr, img, PARAMS, cfg)
        torch.cuda.synchronize()
        ik, ir = sk.view(torch.int32), sr.view(torch.int32)
        assert torch.equal(ik[k1.S_COUNT:], ir[k1.S_COUNT:])
        assert sk[k1.S_NVALID].item() == sr[k1.S_NVALID].item() > 100
        tk, tr = sk[k1.S_TWIST:k1.S_TWIST + 6], sr[k1.S_TWIST:k1.S_TWIST + 6]
        err = ((tk - tr).abs().max() / tr.abs().max()).item()
        assert err <= 1e-4, (i, tk.tolist(), tr.tolist())
        assert (sk[:k1.S_LAM] - sr[:k1.S_LAM]).abs().max().item() <= 1e-5
    brick = form != "dense"
    assert (k1.launches_step, k1.launches_step_brick) == (
        counts[0] + 3 * (not brick), counts[1] + 3 * brick)
    frozen = sk.clone()
    step()  # the count has reached max_iterations: the launch changes nothing
    torch.cuda.synchronize()
    assert torch.equal(sk, frozen)


LAUNCH_SIZES = [1, 255, 257, 34240, 307200]


def _many_points(dev, pose, n):
    """n camera points on ``_sphere_box``'s surface seen from ``pose``:
    ``_surface_points`` tiled with jitter from a seed, a NaN every 17th."""
    base = _surface_points(dev, pose)
    gen = torch.Generator(device=dev).manual_seed(n)
    pts = base.repeat(-(-n // base.shape[0]), 1)[:n]
    pts = pts + 0.005 * torch.randn(n, 3, generator=gen, device=dev)
    pts[::17] = float("nan")
    return pts.contiguous()


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", LAUNCH_SIZES)
@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_reduce_sums_are_the_plain_terms_in_launch_order(dev, form, n):
    """K1's 29 sums (the slab kernel over the whole grid) equal the plain
    per-query terms summed in launch order bit for bit, at ragged, whole and
    many-chunk block counts; a second launch gives the same bits."""
    view, _, pose = _step_view(dev, form)
    pts = _many_points(dev, pose, n)
    out = k1.gn_reduce(view, pose, pts, PARAMS).clone()
    again = k1.gn_reduce(view, pose, pts, PARAMS).clone()
    want = k1.sums_in_launch_order(k1.query_terms_reference(view, pose, pts, PARAMS))
    torch.cuda.synchronize()
    assert _same_bits(out, want), (out - want).abs().max().item()
    assert _same_bits(again, out)
    assert n < 300 or out[27].item() > n // 4


@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_reduce_slab_sums_are_the_plain_terms_in_launch_order(dev, form):
    """The slab form (slab_stepper's reduce) on both ranks of a two-way
    split, the second at i0 > 0: each rank's sums are its plain slab terms
    summed in launch order bit for bit."""
    view, _, pose = _step_view(dev, form)
    pts = _many_points(dev, pose, 34240)
    s = PARAMS.m // 2
    state = k1.init_state(pose, 1e-3)
    for r, v in enumerate(_slab_views(view, 2)):
        out = k1.slab_stepper(v, state, pts, PARAMS, TrackingConfig(), i0=r * s,
                              slab=s)[0]().clone()
        want = k1.sums_in_launch_order(k1.query_terms_reference(v, state, pts, PARAMS,
                                                                i0=r * s, slab=s))
        torch.cuda.synchronize()
        assert out[27].item() > 1000
        assert _same_bits(out, want), (r, (out - want).abs().max().item())


@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_step_is_gn_finish_of_the_plain_terms_in_launch_order(dev, form):
    """Over a level, each gn_step launch leaves the state that gn_finish
    leaves from the same state on the plain terms summed in launch order,
    bit for bit."""
    view, _, pose = _step_view(dev, form)
    pts = _many_points(dev, pose, 34240)
    cfg = TrackingConfig(max_iterations=4, min_iterations=4)
    sk = k1.init_state(pose, cfg.damping)
    sf = sk.clone()
    step, finish = k1.gn_stepper(view, sk, pts, PARAMS, cfg), k1.finisher(sf, cfg)
    for _ in range(cfg.max_iterations):
        finish(k1.sums_in_launch_order(k1.query_terms_reference(view, sf, pts, PARAMS)))
        step()
        torch.cuda.synchronize()
        assert _same_bits(sk, sf)
    assert int(sk.view(torch.int32)[k1.S_COUNT]) == cfg.max_iterations


def test_gn_step_rejects_bad_input(dev):
    view, pts, pose = _step_view(dev, "dense")
    state = k1.init_state(pose, 0.1)
    cfg = TrackingConfig()
    with pytest.raises(ValueError):
        k1.gn_step(view, state, pts.double(), PARAMS, cfg)
    with pytest.raises(ValueError):
        k1.gn_step(view, state[:20], pts, PARAMS, cfg)
    with pytest.raises(ValueError):
        k1.gn_step(view, state, pts.t(), PARAMS, cfg)


@pytest.mark.parametrize("bs", [(8, 8, 8), (1, 8, 16), (4, 4, 2)])
@pytest.mark.parametrize("channels", [2, 6])
def test_brick_merge_kernel_matches_plain(dev, channels, bs):
    """The dense form at the presets' 8^3 bricks and at a flat shape (four
    voxels a thread, float4), and at a k extent of 2 (one voxel a thread):
    every leaf bit for bit; FULL bricks past the cap read the zero row."""
    gen = torch.Generator(device=dev).manual_seed(1)
    m, cap = 64, 40
    nb = (m // bs[0]) * (m // bs[1]) * (m // bs[2])
    base = {k: torch.rand(m, m, m, generator=gen, device=dev) for k in FIELDS}
    base["W"] = (torch.rand(m, m, m, generator=gen, device=dev) * 3.0)
    bid = torch.randperm(nb, generator=gen, device=dev)[:300].sort().values.to(torch.int32)
    cls = torch.where(torch.rand(300, generator=gen, device=dev) < 0.3, 2, 1).to(torch.int32)
    full = torch.nonzero(cls == 2).reshape(-1)
    assert full.numel() > cap
    slot = torch.full((300,), cap, dtype=torch.int32, device=dev)
    slot[full[:cap]] = torch.arange(min(cap, full.numel()), dtype=torch.int32, device=dev)
    upd = torch.rand(cap + 1, *bs, channels, generator=gen, device=dev)
    upd[..., 0][torch.rand(cap + 1, *bs, generator=gen, device=dev) < 0.2] = 0.0
    upd[cap] = 0.0
    gk = TSDFGrid(**{k: v.clone() for k, v in base.items()})
    gr = TSDFGrid(**{k: v.clone() for k, v in base.items()})
    before = k2.launches
    k2.brick_merge(gk, upd, bid, cls, slot, bs=bs, delta=0.15, max_weight=2.0)
    k2.brick_merge_reference(gr, upd, bid, cls, slot, bs=bs, delta=0.15, max_weight=2.0)
    assert k2.launches == before + 1
    for k in FIELDS:
        a, b = getattr(gk, k), getattr(gr, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
        assert torch.equal(a, base[k]) == (k in ("R", "G", "B", "Wc") and channels == 2), k
    assert (gk.W == 2.0).any()


@pytest.mark.parametrize("channels", [2, 6])
@pytest.mark.parametrize("vdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32)])
def test_brick_merge_rows_kernel_matches_plain(dev, channels, vdt, wdt):
    gen = torch.Generator(device=dev).manual_seed(3)
    nb, bv, cap, n_free = 512, 512, 40, 30

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    W = rand(nb, bv, lo=-20.0, hi=140.0).clamp(0.0, 128.0)  # unobserved and clamped
    D = torch.where(W > 0, rand(nb, bv, lo=-0.15, hi=0.15), float("nan"))
    lv, lw = color_lane_widths(bv, vdt, wdt)
    color = [rand(nb, bv).to(vdt) for _ in range(3)] + [W.to(wdt)]
    C = torch.cat([x.view(torch.int16) for x in color], dim=1)
    assert C.shape[1] == 3 * lv + lw
    ids = torch.randperm(nb, generator=gen, device=dev)[:cap + n_free].to(torch.int32)
    ids[::7] = nb  # padding slots
    upd = rand(channels, cap, bv, lo=0.0, hi=2.0)
    upd[0][rand(cap, bv) < 0.2] = 0.0  # voxels with no update
    kw = dict(cap=cap, delta=0.15, max_weight=128.0)
    lk = [D.to(vdt), W.to(wdt), C.clone()]
    lr = [x.clone() for x in lk]
    before = k2.launches_rows
    k2.brick_merge_rows(*lk, upd, ids, **kw)
    k2.brick_merge_rows_reference(*lr, upd, ids, **kw)
    assert k2.launches_rows == before + 1
    for a, b in zip(lk, lr):
        nan = torch.isnan(b) if b.is_floating_point() else torch.zeros_like(b, dtype=bool)
        assert torch.equal(torch.isnan(a) if a.is_floating_point() else nan, nan)
        assert torch.equal(a[~nan].view(torch.int16), b[~nan].view(torch.int16))
    assert (lk[1].float() == 128.0).any()
    assert torch.equal(lk[2], C) == (channels == 2)  # color on FULL slots only


def _slab_views(view, n):
    """Rank r's view of an n-way i-split: its slab of ``view`` and the next
    rank's first plane (dense) or brick layer (brick-major), NaN past the
    last rank."""
    m = PARAMS.m
    s = m // n
    if not isinstance(view, k1.BrickMaskedView):
        nan = torch.full((1, m, m), float("nan"), device=view.device)
        return [torch.cat([view[r * s:(r + 1) * s],
                           view[(r + 1) * s:(r + 1) * s + 1] if r < n - 1 else nan])
                for r in range(n)]
    rows, bs = view.rows, view.bs
    per, layer = rows.shape[0] // n, (m // bs[1]) * (m // bs[2])
    nan = torch.full((layer, rows.shape[1]), float("nan"), device=rows.device,
                     dtype=rows.dtype)
    return [k1.BrickMaskedView(torch.cat([rows[r * per:(r + 1) * per],
                                          rows[(r + 1) * per:(r + 1) * per + layer]
                                          if r < n - 1 else nan]), m, bs, mi=s + bs[0])
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_reduce_slab_kernel_matches_plain(dev, form, n):
    """K1's slab form (the sharded tracker's reduce, ``slab_stepper``) per
    rank against its plain version, the pose read from the GN state buffer:
    equal valid counts, A and b within 1e-4 relative; the slabs' valid
    counts add up to the whole grid's exactly and their sums to its sums
    (ownership partitions the queries)."""
    view, pts, pose = _step_view(dev, form)
    s = PARAMS.m // n
    cfg = TrackingConfig()
    state = k1.init_state(pose, 1e-3)
    brick = form != "dense"
    name = "launches_slab_brick" if brick else "launches_slab"
    before = getattr(k1, name)
    outs = []
    for r, v in enumerate(_slab_views(view, n)):
        reduce, _ = k1.slab_stepper(v, state, pts, PARAMS, cfg, i0=r * s, slab=s)
        out = reduce().clone()
        ref = k1.gn_reduce_slab_reference(v, state, pts, PARAMS, cfg, i0=r * s, slab=s)
        assert out[27].item() == ref[27].item()
        for sl in (slice(0, 21), slice(21, 27)):
            err = (out[sl] - ref[sl]).abs().max() / ref[sl].abs().max().clamp(min=1e-30)
            assert err.item() <= 1e-4
        outs.append(out)
    assert getattr(k1, name) == before + n
    assert int(state.view(torch.int32)[k1.S_TICKET]) == 0  # reset by the last block
    whole = k1.gn_reduce(view, pose, pts, PARAMS)
    _check_gn(torch.stack(outs).sum(0), whole)


@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_gn_finish_kernel_matches_advance_state(dev, form):
    """gn_finish on the same sums as advance_state, over a level, each step
    from the state the kernel left: equal step counts and done flags, the
    twist within 1e-4 relative, the pose within 1e-5 (float64 solve against
    float32)."""
    view, pts, pose = _step_view(dev, form)
    cfg = TrackingConfig(max_iterations=6)
    sk = k1.init_state(pose, cfg.damping)
    sr = torch.empty_like(sk)
    reduce, finish = k1.slab_stepper(view, sk, pts, PARAMS, cfg)
    before = k1.launches_finish
    for _ in range(cfg.max_iterations):
        sums = reduce().clone()
        sr.copy_(sk)
        finish(sums)
        k1.advance_state(sr, *k1.unpack(sums), cfg)
        torch.cuda.synchronize()
        ik, ir = sk.view(torch.int32), sr.view(torch.int32)
        assert torch.equal(ik[k1.S_COUNT:], ir[k1.S_COUNT:])
        assert sk[k1.S_NVALID].item() == sr[k1.S_NVALID].item() > 100
        tk, tr = sk[k1.S_TWIST:k1.S_TWIST + 6], sr[k1.S_TWIST:k1.S_TWIST + 6]
        assert ((tk - tr).abs().max() / tr.abs().max().clamp(min=1e-30)).item() <= 1e-4
        assert (sk[:k1.S_LAM] - sr[:k1.S_LAM]).abs().max().item() <= 1e-5
    assert k1.launches_finish == before + cfg.max_iterations


@pytest.mark.parametrize("form", ["dense", "brick_f32", "brick_bf16"])
def test_one_rank_slab_iteration_is_gn_step_bitwise(dev, form):
    """One rank holding the whole grid (i0 0, slab m): reduce, the identity
    all_reduce and finish equal one gn_step launch bit for bit, step by step
    over a level and on the done launches after it; the done level's sums
    are zeros."""
    view, pts, pose = _step_view(dev, form)
    cfg = TrackingConfig(max_iterations=8)
    sa, sb = k1.init_state(pose, cfg.damping), k1.init_state(pose, cfg.damping)
    reduce, finish = k1.slab_stepper(view, sa, pts, PARAMS, cfg, i0=0, slab=PARAMS.m)
    step = k1.gn_stepper(view, sb, pts, PARAMS, cfg)
    for _ in range(cfg.max_iterations + 2):
        sums = reduce()
        finish(sums)
        step()
        torch.cuda.synchronize()
        assert torch.equal(sa.view(torch.int32), sb.view(torch.int32))
    assert int(sa.view(torch.int32)[k1.S_COUNT]) > 1
    assert torch.equal(sums, torch.zeros_like(sums))  # the level is done


def test_track_slab_on_the_card_is_reduce_allreduce_finish(dev, monkeypatch):
    """The sharded tracker on CUDA tensors, a one-rank mesh double (identity
    all_reduce): max_iterations slab launches, all_reduces and gn_finish
    launches, no advance_state, and the state of a gn_step level bit for bit."""
    from tracking_sdf_tpu_torch.parallel import sharded
    from tracking_sdf_tpu_torch.parallel.mesh import Mesh

    class OneRank(Mesh):
        def all_reduce_(self, t):
            self.collectives += 1
            return t

    def no_advance(*a, **kw):
        raise AssertionError("advance_state ran on the card")

    monkeypatch.setattr(k1, "advance_state", no_advance)
    view, pts, pose = _step_view(dev, "brick_bf16")
    cfg = TrackingConfig(max_iterations=10)
    mesh = OneRank(group=None, size=1, rank=0, backend="nccl", device=dev)
    before = (k1.launches_slab_brick, k1.launches_finish)
    res = sharded.track_slab(view, pose, pts, i0=0, slab=PARAMS.m, params=PARAMS, cfg=cfg,
                             mesh=mesh)
    assert (k1.launches_slab_brick - before[0], k1.launches_finish - before[1],
            mesh.collectives) == (10, 10, 10)
    ref = k1.init_state(pose, cfg.damping)
    step = k1.gn_stepper(view, ref, pts, PARAMS, cfg)
    for _ in range(cfg.max_iterations):
        step()
    assert torch.equal(res.state.view(torch.int32), ref.view(torch.int32))


def test_central_tracker_on_the_card_is_pack_and_gn_finish(dev, monkeypatch):
    """jacobian="central" on CUDA tensors: each of max_iterations iterations
    packs central_sums' normal equations on the device and launches
    gn_finish once; advance_state never runs. The level is held against
    two others: advance_state (a float32 solve) stepped on the card's own
    central sums, and the CPU path (track_frame on CPU copies of the same
    grid, points and pose): the first step's twist within REL_TOL_STEP
    relative, equal step counts and done flags, the level's pose within
    POSE_TOL_LEVEL. The valid count equals the card's own sums' and is
    within two of the CPU path's: the central probes on the card and on the
    CPU round apart, and a pixel at the edge of the observed volume may
    change sides. The points lie on the scene's surfaces, seen from a pose
    27 mm off the start (random points in the volume have no pose to settle
    on, and a level's float32 and float64 solves wander apart)."""
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.tracking import gauss_newton as tgn

    D, W, _, true_pose = _sphere_box(dev)
    grid = TSDFGrid(D=D, W=W, R=D, G=D, B=D, Wc=W)
    cpu_grid = TSDFGrid(D=D.cpu(), W=W.cpu(), R=D.cpu(), G=D.cpu(), B=D.cpu(), Wc=W.cpu())
    pts = _surface_points(dev, true_pose)
    pose = Pose(true_pose.R, true_pose.t + torch.tensor([0.02, -0.015, 0.01], device=dev))
    cfg = TrackingConfig(jacobian="central", max_iterations=10)
    runs = {}
    for n in (1, cfg.max_iterations):
        ref = k1.init_state(pose, cfg.damping)
        for _ in range(n):
            k1.advance_state(ref, *tgn.central_sums(grid, k1.state_pose(ref), pts, PARAMS,
                                                    cfg), cfg)
        cpu = tgn.track_frame(cpu_grid, Pose(pose.R.cpu(), pose.t.cpu()), pts.cpu(),
                              params=PARAMS, cfg=cfg._replace(max_iterations=n)).state
        runs[n] = (ref.cpu(), cpu)

    def no_advance(*a, **kw):
        raise AssertionError("advance_state ran on the card")

    monkeypatch.setattr(k1, "advance_state", no_advance)
    for n, (ref, cpu) in runs.items():
        before = k1.launches_finish
        got = tgn.track_frame(grid, pose, pts, params=PARAMS,
                              cfg=cfg._replace(max_iterations=n)).state.cpu()
        assert k1.launches_finish - before == n
        assert got[k1.S_NVALID].item() == ref[k1.S_NVALID].item() > 100
        assert abs(got[k1.S_NVALID].item() - cpu[k1.S_NVALID].item()) <= 2
        for want in (ref, cpu):
            assert torch.equal(got.view(torch.int32)[k1.S_COUNT:],
                               want.view(torch.int32)[k1.S_COUNT:])
            if n == 1:
                tk, tr = got[k1.S_TWIST:k1.S_TWIST + 6], want[k1.S_TWIST:k1.S_TWIST + 6]
                assert ((tk - tr).abs().max() / tr.abs().max()).item() <= 1e-4
            else:
                assert int(got.view(torch.int32)[k1.S_COUNT]) > 1
                assert (got[:k1.S_LAM] - want[:k1.S_LAM]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("case", ["zeros", "nan", "inf", "rank3"])
def test_gn_finish_on_degenerate_sums(dev, case):
    """gn_finish on sums of no queries, with a NaN in A or an infinite b, and
    on a rank-3 A (J's last three columns equal its first three): the count,
    done flag and ticket of advance_state on the same sums on the CPU (on
    the card torch's float32 solve of the system with a NaN came back
    finite), a zero twist where the solve is not finite (and for no
    queries, whose solve is 0)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    J = torch.randn(200, 6, generator=gen, device=dev)
    if case == "rank3":
        J[:, 3:] = J[:, :3]
    r = torch.randn(200, generator=gen, device=dev) * 0.1
    A, b = J.T @ J, J.T @ r
    A = (A + A.T) / 2
    n, s = torch.tensor(200.0, device=dev), r.abs().sum()
    if case == "zeros":
        A, b, n, s = A * 0, b * 0, n * 0, s * 0
    elif case == "nan":
        A[1, 4] = A[4, 1] = float("nan")
    elif case == "inf":
        b[2] = float("inf")
    sums = k1.pack(A, b, n, s)
    pose = se3_exp(torch.tensor([0.01, -0.02, 0.03, 0.05, -0.02, 0.01], device=dev))
    for cfg in (TrackingConfig(), TrackingConfig(convergence="signed", min_iterations=0)):
        sk = k1.init_state(pose, cfg.damping)
        sr = sk.cpu()
        k1.finisher(sk, cfg)(sums)
        k1.advance_state(sr, *k1.unpack(sums.cpu()), cfg)
        sk = sk.cpu()
        ik, ir = sk.view(torch.int32), sr.view(torch.int32)
        assert torch.equal(ik[k1.S_COUNT:], ir[k1.S_COUNT:]), case
        assert torch.equal(sk[k1.S_NVALID:k1.S_COUNT], sr[k1.S_NVALID:k1.S_COUNT])
        twist = sk[k1.S_TWIST:k1.S_TWIST + 6]
        if case in ("zeros", "nan", "inf"):
            assert torch.equal(twist, torch.zeros_like(twist)), case
            assert torch.equal(sk[:k1.S_LAM], sr[:k1.S_LAM])
        else:
            assert torch.isfinite(twist).all()


def test_slab_stepper_rejects_bad_input(dev):
    view, pts, pose = _step_view(dev, "dense")
    state = k1.init_state(pose, 0.1)
    cfg = TrackingConfig()
    with pytest.raises(ValueError):  # a slab view needs its slab
        k1.slab_stepper(view[:40], state, pts, PARAMS, cfg)
    with pytest.raises(ValueError):
        k1.slab_stepper(view, state[:20], pts, PARAMS, cfg)
    _, finish = k1.slab_stepper(view, state, pts, PARAMS, cfg)
    with pytest.raises(ValueError):
        finish(torch.zeros(29, dtype=torch.float64, device=dev))


@pytest.mark.parametrize("vdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("color", [True, False])
def test_brick_fuse_rows_slab_kernel_matches_plain(dev, color, vdt):
    """K2's slab form on each half of the grid (ids local to the slab,
    i_offset its first voxel) against its plain version, bitwise, and equal
    to the whole-grid kernel run on the same bricks by global id."""
    cam, cfg, pose, pix, _ = _scene_frame(dev, "point_to_point", color)
    gen = torch.Generator(device=dev).manual_seed(7)
    nb, bv, n = (PARAMS.m // 8) ** 3, 512, 2
    s, per = PARAMS.m // n, nb // n

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    W = rand(nb, bv, lo=-20.0, hi=140.0).clamp(0.0, 128.0)
    D = torch.where(W > 0, rand(nb, bv, lo=-0.15, hi=0.15), float("nan"))
    C = pack_color(*(rand(nb, bv).to(vdt) for _ in range(3)),
                   rand(nb, bv, lo=0.0, hi=140.0).clamp(max=128.0).to(vdt))
    whole = [D.to(vdt), W.to(vdt), C.clone()]
    kw = dict(hw=(72, 96), params=PARAMS, cam=cam, cfg=cfg, bs=(8, 8, 8))
    pts, nrm = _scene_points(cam, pose)
    for r in range(n):
        ids, _ = classify_compact_rows(PARAMS, pose, pts, nrm, cam=cam, cfg=cfg,
                                       bs=(8, 8, 8), cap=64, cap_free=64, nbi=s // 8,
                                       i_offset=r * s)
        sl = slice(r * per, (r + 1) * per)
        lk = [x[sl].clone() for x in whole]
        lr = [x.clone() for x in lk]
        before = brick_fuse.launches_slab
        brick_fuse.brick_fuse_rows(*lk, ids, pix, pose, cap=64, i_offset=r * s,
                                   nbi=s // 8, **kw)
        brick_fuse.brick_fuse_rows_reference(*lr, ids, pix, pose, cap=64,
                                             i_offset=r * s, **kw)
        assert brick_fuse.launches_slab == before + 1
        gk = [x.clone() for x in whole]
        gids = torch.where(ids < per, ids + r * per, nb).to(torch.int32).contiguous()
        brick_fuse.brick_fuse_rows(*gk, gids, pix, pose, cap=64, **kw)
        for a, b, g in zip(lk, lr, gk):
            bits = torch.int16 if a.element_size() == 2 else torch.int32
            assert torch.equal(a.view(bits), b.view(bits))
            assert torch.equal(a.view(bits), g[sl].view(bits))


def _scene_points(cam, pose):
    """Points and normals of a sphere, a box and a wall seen from ``pose``."""
    parts = (SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
             CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)),
             CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0)))

    class Scene:
        def intersect(self, o, d):
            t = parts[0].intersect(o, d)
            for p in parts[1:]:
                tb = p.intersect(o, d)
                t = torch.where(torch.isnan(t), tb,
                                torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))
            return t

    return preprocess_frame(render_scene_depth(Scene(), cam, pose), cam=cam, bilateral=False)


def _scene_frame(dev, distance, color):
    """A sphere, a box and a wall seen at 96x72: the pixel table, the pose
    and the frame's FULL then FREE lists (cap 96 / 64, padded slots in both)."""
    cam = PinholeCamera(fx=80.0, fy=80.0, cx=47.5, cy=35.5, width=96, height=72)
    cfg = FusionConfig(mode="brickmajor", pixel_share=4, pixel_share_j=4,
                       distance=distance, max_weight=128.0)
    pose = look_at((0.3, -2.4, 0.15), (0.0, 0.0, 0.0), device=dev)
    pts, nrm = _scene_points(cam, pose)
    rgb = torch.rand(72, 96, 3, generator=torch.Generator(device=dev).manual_seed(5),
                     device=dev)
    nb = (PARAMS.m // 8) ** 3
    ids, counts = classify_compact_rows(PARAMS, pose, pts, nrm, cam=cam, cfg=cfg,
                                        bs=(8, 8, 8), cap=nb, cap_free=nb)
    full, free = ids[:96].clone(), ids[nb:nb + 64].clone()
    full[[3, 40]] = nb
    free[-5:] = nb
    pix = _pixel_table(pts, nrm, rgb if color else None, color, distance)
    return cam, cfg, pose, pix, torch.cat([full, free]).contiguous()


@pytest.mark.parametrize("vdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("color", [True, False])
@pytest.mark.parametrize("weighting", ["exponential", "linear"])
@pytest.mark.parametrize("distance", ["point_to_point", "point_to_plane"])
def test_brick_fuse_rows_kernel_matches_plain(dev, distance, weighting, color, vdt, wdt):
    cam, cfg, pose, pix, ids = _scene_frame(dev, distance, color)
    cfg = cfg._replace(weighting=weighting)
    gen = torch.Generator(device=dev).manual_seed(6)
    nb, bv = (PARAMS.m // 8) ** 3, 512

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    W = rand(nb, bv, lo=-20.0, hi=140.0).clamp(0.0, 128.0)  # unobserved and clamped
    D = torch.where(W > 0, rand(nb, bv, lo=-0.15, hi=0.15), float("nan"))
    C = pack_color(*(rand(nb, bv).to(vdt) for _ in range(3)),
                   rand(nb, bv, lo=0.0, hi=140.0).clamp(max=128.0).to(wdt))
    lk = [D.to(vdt), W.to(wdt), C.clone()]
    lr = [x.clone() for x in lk]
    kw = dict(cap=96, hw=(72, 96), params=PARAMS, cam=cam, cfg=cfg, bs=(8, 8, 8))
    before = brick_fuse.launches
    brick_fuse.brick_fuse_rows(*lk, ids, pix, pose, **kw)
    brick_fuse.brick_fuse_rows_reference(*lr, ids, pix, pose, **kw)
    assert brick_fuse.launches == before + 1
    for a, b in zip(lk, lr):
        nan = torch.isnan(b) if b.is_floating_point() else torch.zeros_like(b, dtype=bool)
        assert torch.equal(torch.isnan(a) if a.is_floating_point() else nan, nan)
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        assert torch.equal(a[~nan].view(bits), b[~nan].view(bits))
    assert (lk[1].float() == 128.0).any()
    assert torch.equal(lk[2], C) != color  # color on FULL slots only


@pytest.mark.parametrize("vdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("color", [True, False])
@pytest.mark.parametrize("weighting", ["exponential", "linear"])
@pytest.mark.parametrize("distance", ["point_to_point", "point_to_plane"])
def test_brick_fuse_rows_sat_kernel_matches_plain(dev, distance, weighting, color, vdt, wdt):
    """The saturated-FREE skip's bitset through K2: half the FREE rows sit at
    their fixed point (D = delta, W = max_weight), and the bits start random.
    Rows and bitset bitwise equal to the plain version: FULL bricks' bits
    cleared, FREE bricks' bits set exactly where their rows came out
    unchanged, other bricks' bits untouched."""
    cam, cfg, pose, pix, ids = _scene_frame(dev, distance, color)
    cfg = cfg._replace(weighting=weighting)
    gen = torch.Generator(device=dev).manual_seed(7)
    nb, bv = (PARAMS.m // 8) ** 3, 512

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    W = rand(nb, bv, lo=-20.0, hi=140.0).clamp(0.0, 128.0)
    D = torch.where(W > 0, rand(nb, bv, lo=-0.15, hi=0.15), float("nan"))
    free = ids[96:][ids[96:] < nb].long()
    D[free[::2]], W[free[::2]] = PARAMS.delta, 128.0
    C = pack_color(*(rand(nb, bv).to(vdt) for _ in range(3)),
                   rand(nb, bv, lo=0.0, hi=140.0).clamp(max=128.0).to(wdt))
    lk = [D.to(vdt), W.to(wdt), C.clone()]
    lr = [x.clone() for x in lk]
    sat0 = rand(nb) < 0.5
    sk, sr = sat0.clone(), sat0.clone()
    kw = dict(cap=96, hw=(72, 96), params=PARAMS, cam=cam, cfg=cfg, bs=(8, 8, 8))
    before = (brick_fuse.launches, brick_fuse.launches_sat)
    brick_fuse.brick_fuse_rows(*lk, ids, pix, pose, sat=sk, **kw)
    brick_fuse.brick_fuse_rows_reference(*lr, ids, pix, pose, sat=sr, **kw)
    assert (brick_fuse.launches, brick_fuse.launches_sat) == (before[0], before[1] + 1)
    for a, b in zip(lk, lr):
        nan = torch.isnan(b) if b.is_floating_point() else torch.zeros_like(b, dtype=bool)
        assert torch.equal(torch.isnan(a) if a.is_floating_point() else nan, nan)
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        assert torch.equal(a[~nan].view(bits), b[~nan].view(bits))
    assert torch.equal(sk, sr)
    full = ids[:96][ids[:96] < nb].long()
    listed = torch.zeros(nb, dtype=torch.bool, device=dev)
    listed[full], listed[free] = True, True
    assert not bool(sk[full].any()) and bool(sk[free[::2]].all())
    assert not bool(sk[free[1::2]].any())
    assert torch.equal(sk[~listed], sat0[~listed])
    # without the bitset the kernel writes what it wrote before
    lp = [x.clone() for x in lr]
    brick_fuse.brick_fuse_rows(*lk, ids, pix, pose, **kw)
    brick_fuse.brick_fuse_rows(*lp, ids, pix, pose, sat=sr.clone(), **kw)
    for a, b in zip(lk, lp):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_dense_reconstruction_on_the_card_matches_cpu(dev):
    """The dense path (PipelineConfig(): dense fusion, the full 2-D filter,
    K1's dense float32 gn_step) at 48^3 on the card against the same loop on
    the CPU, as smoke phase 4 holds the other layouts; the card launches
    gn_step and no plain step."""
    import dataclasses

    from tracking_sdf_tpu_torch.config import PipelineConfig
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    params = GridParams(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                        delta=0.15, epsilon=0.02)
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    parts = (SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
             CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))

    class Scene:
        def intersect(self, o, d):
            t, tb = parts[0].intersect(o, d), parts[1].intersect(o, d)
            return torch.where(torch.isnan(t), tb,
                               torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))

    cfg = dataclasses.replace(PipelineConfig(), grid=params, trajectory_path=None)
    eyes = [(0.0, -1.5, 0.2), (0.02, -1.5, 0.21), (0.04, -1.49, 0.22)]
    runs = []
    for d in ("cpu", dev, dev):
        r = Reconstruction(cam, cfg, device=d,
                           initial_pose=look_at(eyes[0], (0, 0, 0), device=d))
        before = k1.launches_step
        for i, e in enumerate(eyes):
            depth = render_scene_depth(Scene(), cam, look_at(e, (0, 0, 0), device="cpu"))
            r.process_frame(depth.to(d), rgb=torch.full((72, 96, 3), 0.5, device=d),
                            timestamp=i)
        runs.append((r, k1.launches_step - before))
    (a, na), (b, nb_), (b2, _) = runs
    assert na == 0 and nb_ == 2 * cfg.tracking.max_iterations, (na, nb_)
    # the card's path is deterministic: a second run is bitwise the first
    assert torch.equal(b.pose.t, b2.pose.t) and torch.equal(b.pose.R, b2.pose.R)
    assert all(torch.equal(getattr(b.grid, k), getattr(b2.grid, k)) for k in FIELDS)
    dt = float((a.pose.t - b.pose.t.cpu()).abs().max())
    iters = ([s.gn_iterations for s in a.stats], [s.gn_iterations for s in b.stats])
    ga, gb = a.grid, b.grid
    seen, seen_b = ga.W > 0, gb.W.cpu() > 0
    both = seen & seen_b
    dD = float((ga.D - gb.D.cpu()).abs()[both].max())
    dW = float((ga.W - gb.W.cpu()).abs().max())
    report = (f"pose |dt| {dt:.3e}, GN iterations {iters}; W > 0 masks differ on "
              f"{int((seen != seen_b).sum())} voxels, max |dD| {dD:.3e}, max |dW| {dW:.3e}")
    print(report)
    assert dt < 1e-4 and iters[0] == iters[1], report
    assert seen.sum() > 1000 and torch.equal(seen, seen_b) and max(dD, dW) <= 1e-4, report


@pytest.mark.parametrize("pose_init", ["previous", "velocity"])
def test_chunk_replays_match_per_frame_loop(dev, pose_init):
    """process_chunk on the card (CUDA-graph replays; numpy uint16 depth and
    uint8 color staged in pinned host memory and decoded on the card) equals
    the per-frame loop on the same frames bit for bit, with frame 3 all NaN
    (rejected), and adds each replay's launches to the counters."""
    import dataclasses

    import numpy as np

    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    nb = (PARAMS.m // 8) ** 3
    cfg = preset("tum256")
    cfg = dataclasses.replace(cfg, grid=PARAMS, trajectory_path=None, pose_init=pose_init,
                              fusion=cfg.fusion._replace(brick_cap=4 * nb, brick_cap_free=nb))
    scene = _Union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                   CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    eyes = [(0.02 * i, -1.5, 0.2 + 0.01 * i) for i in range(6)]
    depths, rgbs = [], []
    for i, e in enumerate(eyes):
        d = render_scene_depth(scene, cam, look_at(e, (0, 0, 0), device="cpu")).numpy()
        if i == 3:
            d[:] = np.nan
        depths.append(np.where(np.isfinite(d), np.round(d * 5000.0), 0).astype(np.uint16))
        rgbs.append(np.full((72, 96, 3), 40 * i, np.uint8))
    p0 = look_at(eyes[0], (0, 0, 0), device=dev)
    seq = Reconstruction(cam, cfg, initial_pose=p0, device=dev)
    for i in range(6):
        seq.process_frame(depths[i], rgbs[i], timestamp=float(i))
    chk = Reconstruction(cam, cfg, initial_pose=p0, device=dev)
    chk.chunk_phase_metrics = False
    chk.process_frame(depths[0], rgbs[0], timestamp=0.0)
    before = (k1.launches_step_brick, brick_fuse.launches)
    stats = chk.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    assert (k1.launches_step_brick - before[0], brick_fuse.launches - before[1]) == (
        5 * (10 + cfg.tracking.max_iterations), 5)
    assert [(s.rejected, s.gn_iterations, s.num_valid, s.mean_abs_residual) for s in stats] == [
        (s.rejected, s.gn_iterations, s.num_valid, s.mean_abs_residual)
        for s in seq.stats[1:]]
    assert stats[2].rejected and sum(s.rejected for s in stats) == 1
    assert torch.equal(chk.pose.R, seq.pose.R) and torch.equal(chk.pose.t, seq.pose.t)
    for k in ("D", "W", "C"):
        a, b = getattr(chk.brick_grid, k), getattr(seq.brick_grid, k)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k


def test_chunk_capture_with_a_collectable_older_reconstruction(dev, monkeypatch):
    """A Reconstruction whose captured graphs became garbage (it sits in a
    reference cycle with its chunk steps) must not be collected inside
    another one's capture, where destroying a graph invalidates the capture.
    The cyclic GC, when enabled, may run at any allocation; here it runs as
    the next capture begins, just after the older one became garbage. The
    second chunk's capture and its phase calibration succeed and agree with
    the first."""
    import dataclasses
    import gc
    import warnings

    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    cfg = preset("tum256")
    cfg = dataclasses.replace(cfg, grid=PARAMS, trajectory_path=None)
    scene = _Union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                   CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    depths = torch.stack([render_scene_depth(scene, cam, look_at(
        (0.02 * i, -1.5, 0.2 + 0.01 * i), (0, 0, 0), device="cpu")) for i in range(4)]).to(dev)
    p0 = look_at((0.0, -1.5, 0.2), (0, 0, 0), device=dev)

    def run():
        r = Reconstruction(cam, cfg, initial_pose=p0, device=dev)
        r.process_frame(depths[0], timestamp=0.0)
        r.process_chunk(depths[1:])
        return r

    held = [run()]
    pose = (held[0].pose.R.clone(), held[0].pose.t.clone())
    assert held[0]._chunk_steps.recon is held[0]  # a cycle: only the cyclic GC frees it
    begin = torch.cuda.CUDAGraph.capture_begin
    collected = []

    def capture_begin(self, *a, **k):
        begin(self, *a, **k)
        if held:
            held.clear()  # the older Reconstruction is garbage from here on
            if gc.isenabled():
                collected.append(gc.collect())

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        second = run()
    assert not held and not collected  # no collection ran inside the capture
    assert torch.equal(second.pose.R, pose[0]) and torch.equal(second.pose.t, pose[1])


class _Union:
    def __init__(self, *parts):
        self.parts = parts

    def intersect(self, o, d):
        t = self.parts[0].intersect(o, d)
        for s in self.parts[1:]:
            tb = s.intersect(o, d)
            t = torch.where(torch.isnan(t), tb, torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))
        return t


def test_brick_fuse_rows_f32_on_tum256_real_lists(dev):
    """K2 on float32 rows (what fusion.mode="packed" runs) at the tum256
    preset's width: rows fused from a first 640x480 frame, then the second
    frame's real FULL and FREE lists, geometry and color, bitwise against
    the plain version."""
    import dataclasses

    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.core.camera import ros_default_camera
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.pipeline.runner import packed_fusion_config

    cfg = preset("tum256")
    cfg = packed_fusion_config(dataclasses.replace(
        cfg, fusion=cfg.fusion._replace(mode="packed")))
    f, p = cfg.fusion, cfg.grid
    cam = ros_default_camera()
    poses = [look_at(e, (0.0, 0.0, 0.0), device=dev) for e in
             ((0.3, -2.4, 0.15), (0.32, -2.39, 0.16))]
    frames = [_scene_points(cam, pose) for pose in poses]
    bg = empty_brick_grid(p, f.brick_shape, device=dev)
    assert bg.D.dtype == bg.W.dtype == torch.float32
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)
    fuse_frame_brickmajor(bg, poses[0], *frames[0], rgb, params=p, cam=cam, cfg=f,
                          bs=f.brick_shape, cap=f.brick_cap, cap_free=f.brick_cap_free)
    pts, nrm = frames[1]
    ids, _ = classify_compact_rows(p, poses[1], pts, nrm, cam=cam, cfg=f, bs=f.brick_shape,
                                   cap=f.brick_cap, cap_free=f.brick_cap_free)
    NB = bg.D.shape[0]
    assert int((ids[:f.brick_cap] < NB).sum()) > 100 and int((ids[f.brick_cap:] < NB).sum()) > 0
    for color in (False, True):
        pix = _pixel_table(pts, nrm, rgb if color else None, color, f.distance)
        lk = [x.clone() for x in (bg.D, bg.W, bg.C)]
        lr = [x.clone() for x in lk]
        kw = dict(cap=f.brick_cap, hw=(cam.height, cam.width), params=p, cam=cam, cfg=f,
                  bs=f.brick_shape)
        before = brick_fuse.launches
        brick_fuse.brick_fuse_rows(*lk, ids, pix, poses[1], **kw)
        brick_fuse.brick_fuse_rows_reference(*lr, ids, pix, poses[1], **kw)
        assert brick_fuse.launches == before + 1
        for a, b in zip(lk[:2], lr[:2]):
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan)
            assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))
        assert torch.equal(lk[2], lr[2]) and torch.equal(lk[2], bg.C) != color
        assert not torch.equal(lk[1], bg.W)


def _small_config(mode, m=48):
    import dataclasses

    from tracking_sdf_tpu_torch.config import preset

    cfg = preset("tum256")
    nb = (m // 8) ** 3
    return dataclasses.replace(
        cfg, grid=GridParams(m=m, width=2.0, height=2.0, depth=2.0,
                             origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02),
        trajectory_path=None,
        fusion=cfg.fusion._replace(mode=mode, brick_cap=4 * nb, brick_cap_free=nb))


def _small_frames(dev, n=4):
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    scene = _Union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                   CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)),
                   CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0)))
    eyes = [(0.02 * i, -2.4, 0.2 + 0.01 * i) for i in range(n)]
    depths = torch.stack([render_scene_depth(scene, cam, look_at(e, (0, 0, 0), device="cpu"))
                          for e in eyes]).to(dev)
    return cam, depths, look_at(eyes[0], (0, 0, 0), device=dev)


def test_packed_loop_on_the_card_matches_cpu(dev):
    """fusion.mode="packed" at 48^3: float32 rows on the card, K1's brick
    float32 step and K2 on float32 rows launched, against the same loop on
    the CPU: poses within 1e-4 and equal GN iterations, as smoke phase 4
    holds the other layouts, and W > 0 on the same voxels. The tracked poses
    differ by float rounding (K1 sums in another order; ~3e-6 m), which
    moves a voxel that projects next to a pixel boundary onto the other
    pixel: at most 1% of the observed voxels may differ by more than 1e-4 in
    D or 1e-4 relative in W, and D by at most 2e-3 (smoke phase 4's bf16
    bar) anywhere."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cfg = _small_config("packed")
    cam, depths, p0 = _small_frames(dev)
    rgb = torch.full((72, 96, 3), 0.5, device=dev)
    runs = []
    for d in ("cpu", dev):
        r = Reconstruction(cam, cfg, device=d, initial_pose=p0.to(d))
        before = (k1.launches_step_brick, brick_fuse.launches)
        for i in range(depths.shape[0]):
            r.process_frame(depths[i].to(d), rgb.to(d), timestamp=float(i))
        runs.append((r, k1.launches_step_brick - before[0], brick_fuse.launches - before[1]))
    (a, sa, fa), (b, sb, fb) = runs
    assert b.packed and b.brick_grid.D.dtype == torch.float32
    assert (sa, fa) == (0, 0) and sb > 0 and fb == depths.shape[0], (sa, fa, sb, fb)
    dt = float((a.pose.t - b.pose.t.cpu()).abs().max())
    iters = ([s.gn_iterations for s in a.stats], [s.gn_iterations for s in b.stats])
    ga, gb = a.grid, b.grid
    seen, seen_b = ga.W > 0, gb.W.cpu() > 0
    both = seen & seen_b
    dD = (ga.D - gb.D.cpu()).abs()
    dW = (ga.W - gb.W.cpu()).abs() / ga.W.clamp(min=1.0)
    share = float(((dD > 1e-4) | (dW > 1e-4))[both].float().mean())
    report = (f"pose |dt| {dt:.3e}, GN iterations {iters}; W > 0 masks differ on "
              f"{int((seen != seen_b).sum())} voxels, {share:.2e} of the observed past 1e-4, "
              f"max |dD| {float(dD[both].max()):.3e}, max |dW|/max(W, 1) "
              f"{float(dW.max()):.3e}")
    print(report)
    assert dt < 1e-4 and iters[0] == iters[1] and seen.sum() > 1000, report
    assert torch.equal(seen, seen_b) and share <= 1e-2 and float(dD[both].max()) <= 2e-3, report


def test_debug_nans_inside_a_captured_chunk_raises_after_the_replay(dev, monkeypatch):
    """--debug-nans on the card: a clean chunk (CUDA-graph replays under the
    no-sync guard) with the switch on equals one with it off bit for bit;
    a NaN written by device ops into a listed row where W > 0 at the chunk's
    second frame raises FloatingPointError naming that frame, after the
    replays' one read."""
    from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
    from tracking_sdf_tpu_torch.pipeline import chunk as chunked
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.utils import debug_nans

    cfg = _small_config("brickmajor")
    cam, depths, p0 = _small_frames(dev, n=5)

    def run(on):
        r = Reconstruction(cam, cfg, device=dev, initial_pose=p0)
        r.chunk_phase_metrics = False
        with debug_nans.switch(on):
            r.process_frame(depths[0], timestamp=0.0)
            r.process_chunk(depths[1:])
        return r

    off, on = run(False), run(True)
    assert all(torch.equal(getattr(off.brick_grid, k).view(torch.int16),
                           getattr(on.brick_grid, k).view(torch.int16)) for k in "DWC")
    assert torch.equal(off.pose.t, on.pose.t)

    real, tick = tbm.brick_fuse_rows, torch.zeros((), dtype=torch.int64, device=dev)

    def poisoned(D, W, C, ids, pix, pose, **kw):
        real(D, W, C, ids, pix, pose, **kw)
        tick.add_(1)
        NB, BV = D.shape
        rows = ids.clamp(max=NB - 1).long()  # a frame that lists nothing pads with NB
        w = (W[rows] * (ids < NB)[:, None]).reshape(-1)
        j = torch.argmax((w > 0).to(torch.int32)).reshape(1)  # no host read
        flat = rows.gather(0, j // BV) * BV + j % BV
        old = D.view(-1).gather(0, flat)
        # only into a voxel with W > 0: a warm-up's frame lists no row
        hit = (tick == 2) & (w.gather(0, j) > 0)
        D.view(-1).scatter_(0, flat, torch.where(hit, torch.full_like(old, float("nan")),
                                                 old))

    replay = chunked.ChunkSteps.replay

    def counted(self, *a, **k):
        tick.zero_()  # the warm-up and the capture ran the step too
        return replay(self, *a, **k)

    monkeypatch.setattr(tbm, "brick_fuse_rows", poisoned)
    monkeypatch.setattr(chunked.ChunkSteps, "replay", counted)
    with pytest.raises(FloatingPointError, match=r"frame 3 \(chunk of 4\).*NaN in D"):
        run(True)


# --- K3 and K4: depth preprocessing -----------------------------------------------

# the cut a case takes from the 480x640 frame: ragged sizes, a width with
# w % 4 != 0, one pixel, one row, one column
PREPROCESS_CUTS = {"ragged": (37, 53), "tiny": (5, 7), "one": (1, 1), "row": (1, 72),
                   "column": (70, 1), "w%4": (45, 66)}
PREPROCESS_CASES = ["scene", "speckle", "offset", "all_nan", *PREPROCESS_CUTS]


def _preprocess_depth(dev, case):
    """The smoke's scene (sphere, box, wall; ros_default_camera, the first
    pose) rendered at 480x640, with NaN speckle, depth jumps, zero and
    negative depth and an all-NaN row, or cut to a small size from the
    speckled frame, or a speckled copy 4 bytes off a 16-byte boundary
    ("offset": the kernels' scalar loads and stores)."""
    import numpy as np

    from tracking_sdf_tpu_torch.core.camera import ros_default_camera

    cam = ros_default_camera()
    scene = _Union(SphereScene(center=(0.3, 1.2, 0.9), radius=0.45),
                   CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9)),
                   CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0)))
    depth = render_scene_depth(scene, cam, look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7),
                                                   device="cpu")).numpy()
    rng = np.random.default_rng(7)
    if case != "scene":
        depth = depth + rng.normal(scale=0.004, size=depth.shape).astype(np.float32)
        depth[rng.random(depth.shape) < 0.05] = np.nan
        depth[rng.random(depth.shape) < 0.01] = 0.0
        depth[rng.random(depth.shape) < 0.01] = -1.0
        depth[200] = np.nan
    if case == "all_nan":
        depth[:] = np.nan
    shape = PREPROCESS_CUTS.get(case)
    if shape is not None:
        depth = depth[220:220 + shape[0], 300:300 + shape[1]]
    depth = torch.from_numpy(np.ascontiguousarray(depth, dtype=np.float32)).to(dev)
    return cam, _unaligned(depth) if case == "offset" else depth


def _launches():
    from tracking_sdf_tpu_torch.tracking import preprocess as pre
    return pre.launches_pass, pre.launches_2d, pre.launches_normals


@pytest.mark.parametrize("case", ["scene", "speckle", "ragged", "tiny", "all_nan"])
def test_preprocess_kernels_match_plain(dev, case):
    """K3 in both forms and K4 (from depth, and from a point image) bitwise
    their plain versions on the same card tensors, each launch counted: the
    separable filter is one launch."""
    from tracking_sdf_tpu_torch.core.camera import backproject
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    cam, depth = _preprocess_depth(dev, case)
    before = _launches()
    sep = pre.bilateral_filter_separable(depth)
    full = pre.bilateral_filter(depth)
    pts, nrm = pre.preprocess_frame(depth, cam=cam, bilateral=False)
    nrm_pts = pre.estimate_normals(pts)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1, before[2] + 2)
    assert _bits_equal(sep, pre.bilateral_filter_separable_reference(depth)), "separable"
    assert _bits_equal(full, pre.bilateral_filter_reference(depth)), "2-D"
    pts_ref = backproject(cam, depth)
    assert _bits_equal(pts, pts_ref), "points"
    nrm_ref = pre.estimate_normals_reference(pts_ref)
    assert _bits_equal(nrm, nrm_ref), "normals"
    assert _bits_equal(nrm_pts, nrm_ref), "normals from points"
    if case == "all_nan":
        assert all(bool(torch.isnan(x).all()) for x in (sep, full, pts, nrm))
    elif case in ("scene", "speckle"):
        assert float(torch.isfinite(nrm).all(-1).float().mean()) > 0.5


@pytest.mark.parametrize("case", PREPROCESS_CASES)
def test_separable_filter_forms_match_plain_bitwise(dev, case):
    """K3's separable kernel, the filter in one launch and each one-axis
    mode, bitwise its plain version at 480x640, on a copy 4 bytes off 16,
    all NaN, and at 37x53, 5x7, 1x1, 1x72, 70x1 and 45x66 (w % 4 != 0);
    each call one launch."""
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    _, depth = _preprocess_depth(dev, case)
    assert (case == "offset") != pre.aligned16(depth)
    before = _launches()
    sep = pre.bilateral_filter_separable(depth)
    assert _launches() == (before[0] + 1, before[1], before[2])
    assert _bits_equal(sep, pre.bilateral_filter_separable_reference(depth))
    for axis in (0, 1):
        one = pre.bilateral_pass(depth, axis)
        assert _bits_equal(one, pre.bilateral_pass_reference(depth, axis)), axis
    assert _launches()[0] == before[0] + 3
    if case in ("scene", "speckle", "offset", "ragged"):
        assert bool(torch.isfinite(sep).any())


@pytest.mark.parametrize("case", PREPROCESS_CASES)
def test_normals_forms_match_plain_bitwise(dev, case):
    """K4 from depth (points and normals) and from a point image bitwise
    their plain versions on the same inputs as the separable filter's test
    (the point image 4 bytes off 16 for "offset")."""
    from tracking_sdf_tpu_torch.core.camera import backproject
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    cam, depth = _preprocess_depth(dev, case)
    before = _launches()
    pts, nrm = pre.preprocess_frame(depth, cam=cam, bilateral=False)
    pts_ref = backproject(cam, depth)
    nrm_ref = pre.estimate_normals_reference(pts_ref)
    assert _bits_equal(pts, pts_ref) and _bits_equal(nrm, nrm_ref)
    given = _unaligned(pts_ref) if case == "offset" else pts_ref
    assert _bits_equal(pre.estimate_normals(given), nrm_ref)
    assert _launches() == (before[0], before[1], before[2] + 2)


@pytest.mark.parametrize("case", ["speckle", "offset", "w%4"])
def test_compiled_radii_match_the_runtime_radius_code(dev, case):
    """Radii 0-5 of K3 (also 17 and its largest) and of K4 (also 16, 17,
    the first whose column strips take two rounds, and its largest) bitwise
    the plain version: the compiled radii (K3's r = 5, K4's R = 4) and the
    runtime-radius code that serves every other radius give the plain bits."""
    from tracking_sdf_tpu_torch.core.camera import backproject
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    cam, depth = _preprocess_depth(dev, case)
    pts_ref = backproject(cam, depth)
    for r in (*range(6), 17, pre.MAX_RADIUS_PASS):
        want = {pre._PASS_AXIS0: pre.bilateral_pass_reference(depth, 0, r),
                pre._PASS_AXIS1: pre.bilateral_pass_reference(depth, 1, r),
                pre._PASS_SEPARABLE: pre.bilateral_filter_separable_reference(depth, r)}
        for mode, ref in want.items():
            got = pre._bilateral_pass(depth, mode, r, 3.0, 0.03, "test")
            assert _bits_equal(got, ref), (r, mode)
    for r in (*range(6), 16, 17, pre.MAX_BOX_RADIUS):
        want = pre.estimate_normals_reference(pts_ref, pre.DEPTH_CHANGE_FACTOR, r)
        pts = torch.empty_like(pts_ref)
        got = pre._normals(depth, pts, cam, pre.DEPTH_CHANGE_FACTOR, r, "test")
        assert _bits_equal(pts, pts_ref) and _bits_equal(got, want), r
        got = pre._normals(None, pts_ref, None, pre.DEPTH_CHANGE_FACTOR, r, "test")
        assert _bits_equal(got, want), ("points", r)


# the depth images a card path may be handed, each with the values of one
# float32 image: a crop of a larger image, a transposed layout, float64
P4_VIEWS = {
    "crop": lambda d: torch.nn.functional.pad(d, (3, 2, 1, 4), value=7.0)[1:-4, 3:-2],
    "transpose": lambda d: d.t().contiguous().t(),
    "float64": lambda d: d.double(),
}


def test_preprocess_kernels_reject_bad_input(dev):
    """The wrong rank, a bad axis, a negative radius and a radius past a
    kernel's largest raise and launch nothing. A float64, a transposed and a
    cropped depth run on their contiguous float32 copy: each result is
    bitwise the plain version's on the contiguous float32 image."""
    from tracking_sdf_tpu_torch.core.camera import backproject
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    cam, depth = _preprocess_depth(dev, "ragged")
    for fn in (pre.bilateral_filter, pre.bilateral_filter_separable):
        with pytest.raises(ValueError):
            fn(depth[None])
        with pytest.raises(ValueError):
            fn(depth, radius=-1)
    with pytest.raises(ValueError):
        pre.preprocess_frame(depth[None], cam=cam, bilateral=False)
    with pytest.raises(ValueError):
        pre.estimate_normals(depth)
    with pytest.raises(ValueError):
        pre.bilateral_pass(depth, 2)
    pts_ref = backproject(cam, depth)
    nrm_ref = pre.estimate_normals_reference(pts_ref)
    for view, make in P4_VIEWS.items():
        x = make(depth)
        before = _launches()
        assert _bits_equal(pre.bilateral_filter(x), pre.bilateral_filter_reference(depth)), view
        assert _bits_equal(pre.bilateral_filter_separable(x),
                           pre.bilateral_filter_separable_reference(depth)), view
        pts, nrm = pre.preprocess_frame(x, cam=cam, bilateral=False)
        assert _bits_equal(pts, pts_ref) and _bits_equal(nrm, nrm_ref), view
        assert _launches() == (before[0] + 1, before[1] + 1, before[2] + 1)
    given = pts_ref.transpose(0, 1).contiguous().transpose(0, 1)
    assert _bits_equal(pre.estimate_normals(given), nrm_ref)
    before = _launches()
    for call in (lambda: pre.bilateral_filter(depth, radius=pre.MAX_RADIUS_2D + 1),
                 lambda: pre.bilateral_filter_separable(depth, radius=pre.MAX_RADIUS_PASS + 1),
                 lambda: pre.bilateral_pass(depth, 1, radius=pre.MAX_RADIUS_PASS + 1),
                 lambda: pre.estimate_normals(pts_ref, smoothing_radius=pre.MAX_BOX_RADIUS + 1),
                 lambda: pre.estimate_normals(pts_ref, smoothing_radius=-1)):
        with pytest.raises(ValueError):
            call()
    assert _launches() == before
    # the entry points take the wrappers' largest radii and refuse one more
    import ctypes

    from tracking_sdf_tpu_torch.kernels import _build

    lib, stream = _build.library(), _build.stream_ptr(dev)
    small = depth[:8, :12].contiguous()
    out, pts = torch.empty_like(small), torch.empty(8, 12, 3, device=dev)
    nrm, inv2sr = torch.empty_like(pts), 1.0 / (2.0 * 0.03 ** 2)
    sw2 = ctypes.addressof(pre._spatial_weights_sq(pre.RADIUS_2D, 3.0))
    for limit, launch in (
            (pre.MAX_RADIUS_2D, lambda r: lib.tsdf_bilateral_2d(
                small.data_ptr(), out.data_ptr(), 8, 12, r, sw2,
                pre._spatial_weights(min(r, pre.MAX_RADIUS_2D), 3.0, dev).data_ptr(), inv2sr,
                0, stream)),
            (pre.MAX_RADIUS_PASS, lambda r: lib.tsdf_bilateral_pass(
                small.data_ptr(), out.data_ptr(), 8, 12, pre._PASS_SEPARABLE, r,
                ctypes.addressof(pre._spatial_weights_1d(r, 3.0)), inv2sr, 0, stream)),
            (pre.MAX_BOX_RADIUS, lambda r: lib.tsdf_normals(
                small.data_ptr(), pts.data_ptr(), nrm.data_ptr(), 8, 12, 1.0, 1.0, 6.0, 4.0,
                pre.DEPTH_CHANGE_FACTOR, r, 0, stream))):
        assert launch(limit) == 0 and launch(limit + 1) != 0, limit
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["speckle", "offset", "w%4"])
def test_bilateral_2d_radii_match_plain_bitwise(dev, case):
    """K3's 2-D form bitwise the plain version (0 differing values, equal
    NaN masks) at radii 0, 1, 5 (compiled), 7 and 17, and with a range
    weight of 1, at 480x640, on a copy 4 bytes off 16 (scalar loads and
    stores) and at 45x66 (w % 4 != 0); at its largest radius on the image's
    top-left 40x52 (the plain version's taps of the whole frame would not
    fit the card), 4 bytes off 16 for "offset"; one launch a call."""
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    _, depth = _preprocess_depth(dev, case)
    corner = depth[:40, :52].contiguous()
    corner = _unaligned(corner) if case == "offset" else corner
    for r, img in ((0, depth), (1, depth), (pre.RADIUS_2D, depth), (7, depth), (17, depth),
                   (pre.MAX_RADIUS_2D, corner)):
        before = _launches()
        got = pre.bilateral_filter(img, radius=r)
        assert _launches() == (before[0], before[1] + 1, before[2])
        assert _bits_equal(got, pre.bilateral_filter_reference(img, r)), r
        torch.cuda.empty_cache()
    # a range sigma whose 1 / (2 sr^2) rounds to float32 0: every finite tap
    # keeps its spatial weight (the runtime-radius code at the compiled radius)
    got = pre.bilateral_filter(depth, sigma_range=1e30)
    assert _bits_equal(got, pre.bilateral_filter_reference(depth, sigma_range=1e30))


def test_process_frame_takes_cropped_and_transposed_depth(dev):
    """Reconstruction.process_frame on the card with a cropped, a transposed
    and a float64 depth: poses and grid bitwise the contiguous float32
    depth's (the separable filter with brick-major rows and the full 2-D
    filter with dense fusion, at 48^3)."""
    import dataclasses

    from tracking_sdf_tpu_torch.config import PipelineConfig
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cam, depths, p0 = _small_frames(dev, n=3)
    full = dataclasses.replace(PipelineConfig(), grid=_small_config("brickmajor").grid,
                               trajectory_path=None)
    for cfg in (_small_config("brickmajor"), full):
        runs = {}
        for view in ("contiguous", *P4_VIEWS):
            r = Reconstruction(cam, cfg, device=dev, initial_pose=p0)
            for i in range(depths.shape[0]):
                d = depths[i] if view == "contiguous" else P4_VIEWS[view](depths[i])
                r.process_frame(d, timestamp=float(i))
            runs[view] = r
        want = runs.pop("contiguous")
        assert want.stats[-1].gn_iterations > 0
        for view, r in runs.items():
            assert torch.equal(r.pose.R, want.pose.R) and torch.equal(r.pose.t, want.pose.t)
            for k in FIELDS:
                x, y = getattr(r.grid, k), getattr(want.grid, k)
                assert torch.equal(torch.isnan(x), torch.isnan(y)), (view, k)
                assert torch.equal(x.nan_to_num(), y.nan_to_num()), (view, k)


@pytest.mark.parametrize("mode", ["separable", "full"])
def test_preprocess_captured_equals_eager(dev, mode):
    """preprocess_frame captured in a CUDA graph (no host sync inside) and
    replayed on a new frame is bitwise the eager call."""
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    cam, depth = _preprocess_depth(dev, "speckle")
    _, other = _preprocess_depth(dev, "scene")
    buf = torch.full_like(depth, float("nan"))
    pre.preprocess_frame(buf, cam=cam, bilateral_mode=mode)  # warm-up: build, weights
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = pre.preprocess_frame(buf, cam=cam, bilateral_mode=mode)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for frame in (depth, other):
        buf.copy_(frame)
        graph.replay()
        want = pre.preprocess_frame(frame, cam=cam, bilateral_mode=mode)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a).view(torch.int32),
                               torch.nan_to_num(b).view(torch.int32))


# --- K5, K6, K7: the mip, the pixel table, classification and compaction ----

CLASSIFY_SIZES = {"scene": (72, 96), "speckle": (72, 96), "ragged": (37, 53), "tiny": (7, 9),
                  "all_nan": (37, 53)}


def _classify_frame(dev, case, inside=False):
    """Points and normals of the sphere, box and wall of _scene_points at the
    case's size, with NaN speckle and an all-NaN row ("speckle", "ragged",
    "tiny"), or all NaN; seen from outside the m=64 grid or from inside it
    (part of the grid behind the camera and off the image)."""
    h, w = CLASSIFY_SIZES[case]
    cam = PinholeCamera(fx=0.83 * w, fy=0.83 * w, cx=(w - 1) / 2, cy=(h - 1) / 2,
                        width=w, height=h)
    pose = (look_at((0.1, -0.45, 0.1), (0.3, 1.0, 0.25), device=dev) if inside
            else look_at((0.3, -2.4, 0.15), (0.0, 0.0, 0.0), device=dev))
    parts = (SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
             CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)),
             CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0)))
    depth = render_scene_depth(_Union(*parts), cam, pose)
    gen = torch.Generator(device=dev).manual_seed(h * w)
    if case in ("speckle", "ragged", "tiny"):
        depth = torch.where(torch.rand(depth.shape, generator=gen, device=dev) < 0.08,
                            float("nan"), depth)
        depth[h // 3] = float("nan")
    if case == "all_nan":
        depth = torch.full_like(depth, float("nan"))
    pts, nrm = preprocess_frame(depth.contiguous(), cam=cam, bilateral=False)
    rgb = torch.rand(h, w, 3, generator=gen, device=dev)
    return cam, pose, pts, nrm, rgb


def _bits_equal(a, b):
    """Same shape, dtype and bits (NaN payloads compared as NaN)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.is_floating_point():
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _k567():
    from tracking_sdf_tpu_torch.fusion import brick_classify as k567
    return k567


def test_card_divides_by_a_python_scalar_as_its_reciprocal(dev):
    """The rounding that K5 and K6 follow: a float32 tensor divided by a
    Python scalar on the card is the product with card_reciprocal (1 / x in
    double, rounded to float32), also where that differs from the float32
    reciprocal of float32 x."""
    import numpy as np

    x = torch.linspace(-700.0, 700.0, 200003, device=dev)
    scalars = (517.3, 516.5, 525.0, 24.0, 535.4, 481.2, 517.306408)
    assert sum(np.float32(1.0 / s) != np.float32(1.0) / np.float32(s) for s in scalars) == 3
    for s in scalars:
        want = x * _k567().card_reciprocal(s)
        assert torch.equal((x / s).view(torch.int32), want.view(torch.int32)), s


@pytest.mark.parametrize("share", [0.0, 0.0625])
@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
@pytest.mark.parametrize("case", list(CLASSIFY_SIZES))
def test_frame_tables_match_plain(dev, case, distance, share):
    """K5 (mip and table in one launch, and each alone) bitwise against
    _zeta_mip_reference and _pixel_table_reference on the same card tensors."""
    from tracking_sdf_tpu_torch.fusion import brick

    k567 = _k567()
    cam, _, pts, nrm, rgb = _classify_frame(dev, case)
    want_mip = brick._zeta_mip_reference(pts, nrm, cam, PARAMS.delta, distance, share)
    before = k567.launches_tables
    for color in (False, True):
        want_pix = brick._pixel_table_reference(pts, nrm, rgb, color, distance)
        mip, pix = brick.frame_tables(pts, nrm, rgb, color, cam, PARAMS.delta, distance, share)
        alone = brick._pixel_table(pts, nrm, rgb if color else None, color, distance)
        assert _bits_equal(pix, want_pix) and _bits_equal(alone, want_pix)
        for got in (mip, brick._zeta_mip(pts, nrm, cam, PARAMS.delta, distance, share)):
            assert got.offsets == want_mip.offsets and got.dims == want_mip.dims
            for name in ("zeta", "zeta_down", "eta", "eta_down"):
                assert _bits_equal(getattr(got, name), getattr(want_mip, name)), name
    assert k567.launches_tables == before + 6
    if case == "all_nan":
        assert bool((want_mip.zeta == -float("inf")).all())


def _super_classes(pose, pts, nrm, cam, cfg, f, nbi=None, i_offset=0, mip=None):
    from tracking_sdf_tpu_torch.fusion import brick

    return brick.classify_bricks_reference(
        PARAMS, pose, pts, nrm, cam, (8 * f,) * 3, cfg.distance, mip=mip,
        nbi=None if nbi is None else nbi // f, i_offset=i_offset).reshape(-1)


@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("case", ["scene", "speckle", "tiny", "all_nan"])
def test_classify_kernel_forms_match_plain(dev, case, inside):
    """K6's flat, super and children forms on the plain mip: the classes of
    classify_bricks_reference, bit for bit, on the whole grid and on a slab
    (i_offset > 0); the super form's "all children saturated"; the children's
    global ids (NB on padding slots)."""
    from tracking_sdf_tpu_torch.fusion import brick

    k567 = _k567()
    cam, pose, pts, nrm, _ = _classify_frame(dev, case, inside)
    cfg = FusionConfig(mode="brickmajor", distance="point_to_plane", pixel_share=4,
                       pixel_share_j=4)
    share = brick.share_classify_margin(PARAMS, cfg)
    mip = brick._zeta_mip_reference(pts, nrm, cam, PARAMS.delta, cfg.distance, share)
    R, base = brick._card_pose(pose)
    hw = tuple(pts.shape[:2])
    gen = torch.Generator(device=dev).manual_seed(3)
    for nbi, i_offset in ((8, 0), (4, 32)):
        want = brick.classify_bricks_reference(PARAMS, pose, pts, nrm, cam, (8, 8, 8),
                                               cfg.distance, mip=mip, nbi=nbi,
                                               i_offset=i_offset).reshape(-1)
        got, _ = k567.classify_bricks(mip, R, base, params=PARAMS, cam=cam, hw=hw,
                                      bs=(8, 8, 8), grid=(nbi, 8, 8), i_offset=i_offset)
        assert torch.equal(got.to(torch.int32), want)
        nb = want.numel()
        for f in (2, 4):
            ns3 = (nbi // f, 8 // f, 8 // f)
            swant = _super_classes(pose, pts, nrm, cam, cfg, f, nbi, i_offset, mip)
            sat = torch.rand(nb, generator=gen, device=dev) < 0.7
            sat.view(ns3[0], f, ns3[1], f, ns3[2], f)[0, :, 0, :, 0, :] = True
            sgot, sat_super = k567.classify_bricks(
                mip, R, base, params=PARAMS, cam=cam, hw=hw, bs=(8 * f,) * 3, grid=ns3,
                i_offset=i_offset, sat=sat, factor=f)
            assert torch.equal(sgot.to(torch.int32), swant)
            all_sat = (sat.view(ns3[0], f, ns3[1], f, ns3[2], f).permute(0, 2, 4, 1, 3, 5)
                       .reshape(-1, f ** 3).all(1))
            assert torch.equal(sat_super, all_sat) and bool(all_sat[0])
            # every super listed, then two padding slots
            ns = swant.numel()
            mixed = torch.cat([torch.arange(ns, device=dev, dtype=torch.int32),
                               torch.full((2,), ns, device=dev, dtype=torch.int32)])
            fcls, gid = k567.classify_children(mip, R, base, mixed, params=PARAMS, cam=cam,
                                               hw=hw, bs=(8, 8, 8), grid=(nbi, 8, 8),
                                               i_offset=i_offset, factor=f)
            s = torch.arange(ns, device=dev)
            c = torch.arange(f ** 3, device=dev)
            ib = (s // (ns3[1] * ns3[2]))[:, None] * f + c // (f * f)
            jb = ((s // ns3[2]) % ns3[1])[:, None] * f + (c // f) % f
            kb = (s % ns3[2])[:, None] * f + c % f
            gwant = torch.cat([((ib * 8 + jb) * 8 + kb).reshape(-1),
                               torch.full((2 * f ** 3,), nb, device=dev)])
            assert torch.equal(gid.long(), gwant)
            assert torch.equal(fcls[:ns * f ** 3].to(torch.int32), want[gwant[:ns * f ** 3]])
            assert not bool(fcls[ns * f ** 3:].any())
    if case == "all_nan":
        assert not bool((want == 1).any())


@pytest.mark.parametrize("case", ["scene", "speckle"])
@pytest.mark.parametrize("name", ["tum256", "tum512"])
def test_classify_forms_at_preset_shapes_match_plain(dev, name, case):
    """K6's three forms at a preset's real shapes (the 640x480 frame, the
    preset's grid and bricks, its filter), on the smoke scene and a speckled
    copy: the flat form over every brick and over the half-grid slab, the
    super form with and without a sat bitset (some supers fully saturated),
    and the children of the listed mixed supers with a padding slot; class
    bytes, sat_super and global ids bitwise the plain versions."""
    _check_classify_forms(dev, name, case)


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("name", ["tum256", "tum512"])
def test_classify_lanes_match_plain(dev, name, lanes, monkeypatch):
    """Each of K6's two instantiations (1 and 8 lanes a brick) on every
    launch of the preset-shape test above, whichever the card's SM count
    would pick: the same bits as the plain versions."""
    k567 = _k567()
    monkeypatch.setattr(k567, "CLASSIFY_LANE_THREADS", 0 if lanes == 1 else 1 << 40)
    assert {k567.classify_lanes(n, 132) for n in (1, 4096, 32768, 98304)} == {lanes}
    _check_classify_forms(dev, name, "speckle")


def _check_classify_forms(dev, name, case):
    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.fusion import brick

    k567 = _k567()
    cam, depth = _preprocess_depth(dev, case)
    cfg = preset(name)
    f, p = cfg.fusion, cfg.grid
    pts, nrm = preprocess_frame(depth, cam=cam, bilateral=cfg.bilateral_filter,
                                bilateral_mode=cfg.bilateral_mode)
    pose = look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7), device=dev)
    pose = Pose(pose.R.contiguous(), pose.t.contiguous())
    share = brick.share_classify_margin(p, f)
    mip = brick._zeta_mip_reference(pts, nrm, cam, p.delta, f.distance, share)
    R, base = brick._card_pose(pose)
    geo = dict(params=p, cam=cam, hw=tuple(pts.shape[:2]))
    bs, fac = f.brick_shape, max(f.hier_classify, 2)
    nb3 = tuple(p.m // b for b in bs)
    for nbi, i_offset in ((nb3[0], 0), (nb3[0] // 2, p.m // 2)):
        grid = (nbi,) + nb3[1:]
        want = brick.classify_bricks_reference(p, pose, pts, nrm, cam, bs, f.distance, mip=mip,
                                               nbi=nbi, i_offset=i_offset).reshape(-1)
        got, _ = k567.classify_bricks(mip, R, base, bs=bs, grid=grid, i_offset=i_offset, **geo)
        assert torch.equal(got.to(torch.int32), want), (nbi, i_offset)
        assert i_offset or int((want == 2).sum()) > 0
        ns3 = tuple(n // fac for n in grid)
        sbs = tuple(b * fac for b in bs)
        swant = brick.classify_bricks_reference(p, pose, pts, nrm, cam, sbs, f.distance, mip=mip,
                                                nbi=ns3[0], i_offset=i_offset).reshape(-1)
        gen = torch.Generator(device=dev).manual_seed(nbi)
        sat = torch.rand(want.numel(), generator=gen, device=dev) < 0.9
        sat.view(ns3[0], fac, ns3[1], fac, ns3[2], fac)[::3, :, ::2, :, :, :] = True
        sat_want = (sat.view(ns3[0], fac, ns3[1], fac, ns3[2], fac).permute(0, 2, 4, 1, 3, 5)
                    .reshape(-1, fac ** 3).all(1))
        kw = dict(bs=sbs, grid=ns3, i_offset=i_offset, factor=fac, **geo)
        plain, none = k567.classify_bricks(mip, R, base, **kw)
        sgot, sat_super = k567.classify_bricks(mip, R, base, sat=sat, **kw)
        assert none is None and torch.equal(plain, sgot)
        assert torch.equal(sgot.to(torch.int32), swant)
        assert torch.equal(sat_super, sat_want) and 0 < int(sat_want.sum()) < sat_want.numel()
        # the listed mixed supers, then a padding slot
        ns = swant.numel()
        mixed = torch.cat([torch.nonzero(swant == 2).reshape(-1),
                           torch.full((1,), ns, device=dev)]).int()
        fcls, gid = k567.classify_children(mip, R, base, mixed, bs=bs, grid=grid,
                                           i_offset=i_offset, factor=fac, **geo)
        s = mixed[:-1].long()[:, None]
        c = torch.arange(fac ** 3, device=dev)
        ib = (s // (ns3[1] * ns3[2])) * fac + c // (fac * fac)
        jb = ((s // ns3[2]) % ns3[1]) * fac + (c // fac) % fac
        kb = (s % ns3[2]) * fac + c % fac
        gwant = ((ib * grid[1] + jb) * grid[2] + kb).reshape(-1)
        n = gwant.numel()
        assert torch.equal(gid[:n].long(), gwant) and bool((gid[n:] == want.numel()).all())
        assert torch.equal(fcls[:n].to(torch.int32), want[gwant])
        assert not bool(fcls[n:].any()) and n > 0


@pytest.mark.parametrize("sat_case", ["none", "partly"])
@pytest.mark.parametrize("caps", ["wide", "tight"])
@pytest.mark.parametrize("slab", [False, True])
@pytest.mark.parametrize("hier", [0, 2, 4])
def test_classify_compact_kernels_match_plain(dev, hier, slab, caps, sat_case):
    """classify_compact_rows on the card (K5, K6, K7: 3 launches flat, 5
    hierarchical) against classify_compact_rows_reference on the same card
    tensors: ids and counts bit for bit, with caps that bind nowhere and with
    tight caps that overflow FULL, FREE and mixed, with sat partly set (one
    FREE super's children all set), on the whole grid and on a slab."""
    from tracking_sdf_tpu_torch.fusion import brick
    from tracking_sdf_tpu_torch.fusion.brickmajor import classify_compact_rows_reference

    k567 = _k567()
    nbi, i_offset = (4, 32) if slab else (8, 0)
    nb = nbi * 64
    cap, cap_free, cap_mixed = (nb, nb, nb) if caps == "wide" else (20, 12, 3)
    cfg = FusionConfig(mode="brickmajor", distance="point_to_plane", pixel_share=4,
                       pixel_share_j=4, hier_classify=hier, cap_mixed=cap_mixed)
    drops = 0
    for case, inside in (("scene", False), ("speckle", True), ("tiny", False),
                         ("all_nan", False)):
        cam, pose, pts, nrm, _ = _classify_frame(dev, case, inside)
        sat = None
        if sat_case == "partly":
            gen = torch.Generator(device=dev).manual_seed(11)
            sat = torch.rand(nb, generator=gen, device=dev) < 0.3
            if hier:  # all children of the first FREE super
                scls = _super_classes(pose, pts, nrm, cam, cfg, hier, nbi, i_offset)
                free = torch.nonzero(scls == 1).reshape(-1)
                if free.numel():
                    f, s = hier, int(free[0])
                    n3 = (nbi // f, 8 // f, 8 // f)
                    v = sat.view(n3[0], f, n3[1], f, n3[2], f)
                    v[s // (n3[1] * n3[2]), :, (s // n3[2]) % n3[1], :, s % n3[2], :] = True
        kw = dict(cam=cam, cfg=cfg, bs=(8, 8, 8), cap=cap, cap_free=cap_free,
                  nbi=nbi if slab else None, i_offset=i_offset)
        want = classify_compact_rows_reference(PARAMS, pose, pts, nrm, sat=sat, **kw)
        before = (k567.launches_tables, k567.launches_classify, k567.launches_compact)
        got = classify_compact_rows(PARAMS, pose, pts, nrm, sat=sat, **kw)
        n = 2 if hier else 1
        assert (k567.launches_tables, k567.launches_classify, k567.launches_compact) == (
            before[0] + 1, before[1] + n, before[2] + n)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (case, got[1],
                                                                                 want[1])
        drops += int(want[1][2]) + int(want[1][3]) + max(int(want[1][0]) - cap, 0)
        if hier:
            hwant = brick.classify_compact_hier_reference(
                PARAMS, pose, pts, nrm, cam, (8, 8, 8), cfg.distance, cap, cap_free, hier,
                cap_mixed, brick.share_classify_margin(PARAMS, cfg), sat, nbi, i_offset)
            hgot = brick.classify_compact_hier(
                PARAMS, pose, pts, nrm, cam, (8, 8, 8), cfg.distance, cap, cap_free, hier,
                cap_mixed, brick.share_classify_margin(PARAMS, cfg), sat, nbi, i_offset)
            for a, b in zip(hgot, hwant):
                assert torch.equal(a, b)
    assert (drops > 0) == (caps == "tight")


@pytest.mark.parametrize("hier", [0, 4])
def test_classify_compact_captured_equals_eager(dev, hier):
    """frame_tables and classify_compact_rows captured in a CUDA graph (no
    host sync inside) and replayed on new frames: bitwise the eager calls."""
    from tracking_sdf_tpu_torch.fusion import brick

    cfg = FusionConfig(mode="brickmajor", distance="point_to_plane", pixel_share=4,
                       pixel_share_j=4, hier_classify=hier, cap_mixed=3)
    frames = [_classify_frame(dev, "scene"), _classify_frame(dev, "speckle", inside=True)]
    cam = frames[0][0]
    pts, nrm, rgb = (torch.empty_like(x) for x in frames[0][2:])
    R, t = (torch.empty_like(x) for x in (frames[0][1].R, frames[0][1].t))
    from tracking_sdf_tpu_torch.core.lie import Pose

    sat = torch.zeros(512, dtype=torch.bool, device=dev)
    sat[::3] = True
    kw = dict(cam=cam, cfg=cfg, bs=(8, 8, 8), cap=40, cap_free=24, sat=sat)
    share = brick.share_classify_margin(PARAMS, cfg)

    def step():
        mip, pix = brick.frame_tables(pts, nrm, rgb, True, cam, PARAMS.delta, cfg.distance,
                                      share)
        return classify_compact_rows(PARAMS, Pose(R, t), pts, nrm, mip=mip, **kw) + (pix,)

    for x in (pts, nrm, rgb):
        x.fill_(float("nan"))
    R.copy_(frames[0][1].R)
    t.copy_(frames[0][1].t)
    step()  # warm-up: the library, the ticket word
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _, pose, p, n, c in frames:
        for dst, src in ((pts, p), (nrm, n), (rgb, c), (R, pose.R), (t, pose.t)):
            dst.copy_(src)
        graph.replay()
        want = step()
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert _bits_equal(a, b)
        assert int(want[1][0]) > 0


def test_classify_kernels_reject_bad_input(dev):
    from tracking_sdf_tpu_torch.fusion import brick

    k567 = _k567()
    cam, pose, pts, nrm, rgb = _classify_frame(dev, "ragged")
    with pytest.raises(ValueError):
        k567.frame_tables(pts.double(), nrm, None, cam=cam, delta=0.1)
    with pytest.raises(ValueError):
        k567.frame_tables(pts.transpose(0, 1), nrm.transpose(0, 1), None, cam=cam, delta=0.1)
    with pytest.raises(ValueError):
        k567.frame_tables(pts, nrm, None, cam=cam, delta=0.1, fuse_color=True)
    with pytest.raises(ValueError):
        k567.frame_tables(pts, nrm, None, mip=True, table=False)  # no camera
    mip, _ = k567.frame_tables(pts, nrm, None, cam=cam, delta=0.1, table=False)
    R, base = brick._card_pose(pose)
    geo = dict(params=PARAMS, cam=cam, hw=(37, 53), bs=(8, 8, 8), grid=(8, 8, 8))
    with pytest.raises(ValueError):
        k567.classify_bricks(mip, R.double(), base, **geo)
    with pytest.raises(ValueError):
        k567.classify_bricks(mip, R, base, sat=torch.zeros(7, dtype=torch.bool, device=dev),
                             **geo)
    with pytest.raises(ValueError):
        k567.classify_children(mip, R, base, torch.zeros(4, dtype=torch.int64, device=dev),
                               factor=2, **geo)
    cls, _ = k567.classify_bricks(mip, R, base, **geo)
    with pytest.raises(ValueError):
        k567.compact_lists(cls.to(torch.int32), None, 8, 8, 512)
    with pytest.raises(ValueError):
        k567.compact_lists(cls, torch.zeros(3, dtype=torch.bool, device=dev), 8, 8, 512)
    with pytest.raises(ValueError):
        k567.compact_lists(cls.cpu(), None, 8, 8, 512)


# ---- K7 redesigned (multi-block look-back scan) and K5 (vector loads) ----

def _plain_compact(cls, skip, cap_a, cap_b, fill):
    """K7's flat form in plain PyTorch: brick._compact_ids of the FULL and
    the not-skipped FREE flags, and the counts."""
    from tracking_sdf_tpu_torch.fusion import brick

    full = cls == 2
    free = cls == 1 if skip is None else (cls == 1) & ~skip
    n_free = free.sum()
    ids = torch.cat([brick._compact_ids(full, cap_a, fill),
                     brick._compact_ids(free, cap_b, fill)]).to(torch.int32)
    return ids, torch.stack([full.sum(), n_free, torch.clamp(n_free - cap_b, min=0),
                             torch.zeros_like(n_free)])


def _plain_compact_hier(fcls, gid, sat, sf_ids, super_counts, cap, cap_free, cap_mixed,
                        grid, f):
    """K7's hierarchical form in plain PyTorch: the compaction steps of
    brick.classify_compact_hier_reference on the given children, kept FREE
    supers and super counts."""
    from tracking_sdf_tpu_torch.fusion import brick

    nbi, nbj, nbk = grid
    NB, vol = nbi * nbj * nbk, f ** 3
    nsj, nsk = nbj // f, nbk // f
    NS = (nbi // f) * nsj * nsk
    dev = fcls.device
    full_ids = brick._compact_vals(fcls == 2, gid, cap, NB)
    free_fine = fcls == 1
    if sat is not None:
        free_fine = free_fine & ~sat[gid.clamp(max=NB - 1).long()]
    n_free_mixed = free_fine.sum()
    fr_ids = brick._compact_vals(free_fine, gid, cap_free, NB)
    cap_sfree = sf_ids.numel()
    valid_sf = sf_ids < NS
    s = torch.where(valid_sf, sf_ids, 0).long()
    la = torch.arange(f, device=dev)
    fi = (s // (nsj * nsk))[:, None] * f + la
    fj = ((s // nsk) % nsj)[:, None] * f + la
    fk = (s % nsk)[:, None] * f + la
    g = (fi[:, :, None, None] * (nbj * nbk) + fj[:, None, :, None] * nbk
         + fk[:, None, None, :]).reshape(cap_sfree, vol)
    sf_gid = torch.where(valid_sf[:, None], g, NB).reshape(-1).to(torch.int32)
    pos = n_free_mixed + torch.arange(cap_sfree * vol, device=dev)
    kept = valid_sf[:, None].expand(cap_sfree, vol).reshape(-1)
    keep = kept & (pos < cap_free)
    n_sat = torch.zeros((), dtype=torch.int64, device=dev)
    if sat is not None:
        sat_child = sat[sf_gid.clamp(max=NB - 1).long()] & kept
        keep = keep & ~sat_child
        n_sat = sat_child.sum()
    fr_ids = torch.cat([fr_ids, fr_ids.new_full((1,), NB)]).scatter_(
        0, torch.where(keep, pos, cap_free), sf_gid)[:cap_free]
    n_mixed, n_sf = super_counts[0], super_counts[1]
    n_free = n_free_mixed + vol * n_sf - n_sat
    ovf_free = (torch.clamp(n_free_mixed + vol * torch.clamp(n_sf, max=cap_sfree) - cap_free,
                            min=0) + vol * torch.clamp(n_sf - cap_sfree, min=0))
    ids = torch.cat([full_ids, fr_ids]).to(torch.int32)
    return ids, torch.stack([(fcls == 2).sum(), n_free, ovf_free,
                             torch.clamp(n_mixed - cap_mixed, min=0)])


def _flag_sets(n, gen, dev):
    """(name, classes) for n flags: random, all FULL, all FREE, none set."""
    r = torch.rand(n, generator=gen, device=dev)
    return (("random", torch.where(r < 0.3, 2, torch.where(r < 0.55, 1, 0)).to(torch.uint8)),
            ("all FULL", torch.full((n,), 2, dtype=torch.uint8, device=dev)),
            ("all FREE", torch.ones(n, dtype=torch.uint8, device=dev)),
            ("none", torch.zeros(n, dtype=torch.uint8, device=dev)))


def _caps(count, preset):
    """Caps of 0, 1, exactly the count, one below it, and the preset's."""
    return sorted({0, 1, count, max(count - 1, 0), preset})


# 1, 31, one tile (2,048 flags) and one tile +- 1, several tiles, then the
# presets' sizes: the supers (4,096), tum256's bricks (32,768), tum512's
# listed children (98,304)
COMPACT_N = (1, 31, 2047, 2048, 2049, 5 * 2048 + 7, 4096, 32768, 98304)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n", COMPACT_N)
def test_compact_lists_kernel_matches_plain(dev, n, skip):
    """K7's flat form bitwise against the plain compaction: ids and counts
    for every flag set and cap, with and without the skip bits, and the
    launches counted."""
    k567 = _k567()
    gen = torch.Generator(device=dev).manual_seed(n)
    sk = torch.rand(n, generator=gen, device=dev) < 0.4 if skip else None
    for what, cls in _flag_sets(n, gen, dev):
        full = int((cls == 2).sum())
        free = int(((cls == 1) & (~sk if skip else True)).sum())
        for cap_a, cap_b in zip(_caps(full, 6144), _caps(free, 2048)[::-1]):
            want = _plain_compact(cls, sk, cap_a, cap_b, n)
            before = k567.launches_compact
            got = k567.compact_lists(cls, sk, cap_a, cap_b, n)
            assert k567.launches_compact == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b), (what, cap_a, cap_b)
        for cap_a, cap_b in ((full, free), (max(full - 1, 0), max(free - 1, 0)), (0, 0),
                             (1, 1)):
            got = k567.compact_lists(cls, sk, cap_a, cap_b, n)
            want = _plain_compact(cls, sk, cap_a, cap_b, n)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (what, cap_a, cap_b)


# (n = cap_mixed f^3, factor, fine grid): f = 1 for the small sizes, then
# tile edges at f = 2, and tum512's supers of 4^3 at its cap_mixed 1,536
HIER_CASES = ((1, 1, (8, 8, 8)), (31, 1, (8, 8, 8)), (2048, 2, (32, 32, 32)),
              (2056, 2, (32, 32, 32)), (2040, 2, (32, 32, 32)), (4096, 4, (64, 64, 64)),
              (32768, 4, (64, 64, 64)), (98304, 4, (64, 64, 64)))


@pytest.mark.parametrize("sat", [False, True])
@pytest.mark.parametrize("case", HIER_CASES, ids=lambda c: f"n{c[0]}-f{c[1]}")
def test_compact_lists_hier_kernel_matches_plain(dev, case, sat):
    """K7's hierarchical form bitwise against the plain compaction steps of
    classify_compact_hier_reference: ids and counts for every flag set, caps
    of 0, 1, exactly the counts and one below, tum512's caps, and with the
    sat bits (saturated FREE children left out, saturated children of the
    kept FREE supers left as holes)."""
    k567 = _k567()
    n, f, grid = case
    vol = f ** 3
    cap_mixed = n // vol
    NB = grid[0] * grid[1] * grid[2]
    NS = NB // vol
    gen = torch.Generator(device=dev).manual_seed(n + f)
    satb = torch.rand(NB, generator=gen, device=dev) < 0.3 if sat else None
    cap_sfree = max(min(64, NS // 2), 1)
    sf_ids = torch.argsort(torch.rand(NS, generator=gen, device=dev))[:cap_sfree]
    sf_ids = sf_ids.to(torch.int32)
    sf_ids[cap_sfree * 3 // 4:] = NS  # padding slots at the end
    pad = n // 7  # padding slots of the children: class 0, id NB
    for what, fcls in _flag_sets(n, gen, dev):
        gid = torch.randint(0, NB, (n,), generator=gen, device=dev, dtype=torch.int32)
        fcls = fcls.clone()
        if pad:
            gid[n - pad:] = NB
            fcls[n - pad:] = 0
        valid = int((sf_ids < NS).sum())
        full = int((fcls == 2).sum())
        free = fcls == 1
        if sat:
            free = free & ~satb[gid.clamp(max=NB - 1).long()]
        nfm = int(free.sum())  # the FREE children of mixed supers, not saturated
        for n_mixed, n_sf in ((cap_mixed, valid), (cap_mixed + 5, valid + 3)):
            super_counts = torch.tensor([n_mixed, n_sf, 0, 0], dtype=torch.int64, device=dev)
            for cap, cap_free in (*zip(_caps(full, 28672), _caps(nfm, 8192)),
                                  (full, nfm + vol * valid), (full, nfm + 5)):
                want = _plain_compact_hier(fcls, gid, satb, sf_ids, super_counts, cap,
                                           cap_free, cap_mixed, grid, f)
                got = k567.compact_lists_hier(fcls, gid, satb, sf_ids, super_counts, cap=cap,
                                              cap_free=cap_free, cap_mixed=cap_mixed,
                                              grid=grid, factor=f)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (what, n_mixed, n_sf, cap, cap_free)


@pytest.mark.parametrize("hier", [0, 4])
def test_classify_compact_graph_replays_reset_the_scratch(dev, hier):
    """classify_compact_rows (K5, K6 and a multi-tile K7) captured once in a
    CUDA graph at 256^3 and replayed 100 times, the pose and the sat bits
    changed between replays (so the flags change): each replay bitwise the
    eager call on the same inputs, so K7's tickets and status words return
    to 0 after every launch."""
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.fusion import brick

    params = GridParams(m=256, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                        delta=0.15, epsilon=0.02)
    cfg = FusionConfig(mode="brickmajor", distance="point_to_plane", pixel_share=4,
                       pixel_share_j=4, hier_classify=hier, cap_mixed=256)
    cam, pose0, pts, nrm, _ = _classify_frame(dev, "speckle")
    R, t = pose0.R.clone(), pose0.t.clone()
    nb = (256 // 8) ** 3
    sat = torch.zeros(nb, dtype=torch.bool, device=dev)
    kw = dict(cam=cam, cfg=cfg, bs=(8, 8, 8), cap=4096, cap_free=2048, sat=sat)
    share = brick.share_classify_margin(params, cfg)

    def step():
        mip = brick._zeta_mip(pts, nrm, cam, params.delta, cfg.distance, share)
        return classify_compact_rows(params, Pose(R, t), pts, nrm, mip=mip, **kw)

    step()  # warm-up: the library, the ticket word, K7's scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    gen = torch.Generator(device=dev).manual_seed(5)
    seen = set()
    for i in range(100):
        twist = (torch.rand(6, generator=gen, device=dev) - 0.5) * torch.tensor(
            [0.2, 0.2, 0.2, 0.1, 0.1, 0.1], device=dev)
        dp = se3_exp(twist)
        R.copy_(dp.R @ pose0.R)
        t.copy_(dp.R @ pose0.t + dp.t)
        sat.copy_(torch.rand(nb, generator=gen, device=dev) < 0.2 * (i % 3))
        graph.replay()
        want = step()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1]), i
        seen.add(tuple(want[1].tolist()))
    assert len(seen) > 10  # the lists changed from replay to replay


def _random_frame(dev, h, w, seed):
    """Points in front of a camera with NaN speckle, normals mostly facing
    it, rgb: made from a seed at any size."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cam = PinholeCamera(fx=0.83 * w + 1, fy=0.83 * w + 1, cx=(w - 1) / 2, cy=(h - 1) / 2,
                        width=w, height=h)
    z = 0.5 + 2.5 * torch.rand(h, w, generator=gen, device=dev)
    u = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    v = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    pts = torch.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], -1)
    nrm = torch.nn.functional.normalize(
        torch.rand(h, w, 3, generator=gen, device=dev) - torch.tensor([0.5, 0.5, 1.2],
                                                                      device=dev), dim=-1)
    hole = torch.rand(h, w, generator=gen, device=dev) < 0.1
    pts = torch.where(hole[..., None], float("nan"), pts)
    rgb = torch.rand(h, w, 3, generator=gen, device=dev)
    return cam, pts.contiguous(), nrm.contiguous(), rgb


def _unaligned(x):
    """A contiguous copy of x that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 4
    return y


@pytest.mark.parametrize("hw", [(9, 17), (37, 53), (1, 1), (8, 8), (72, 96), (480, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_frame_tables_vector_and_scalar_loads_match_plain(dev, hw):
    """K5 bitwise against _zeta_mip_reference and _pixel_table_reference at
    widths with w % 4 != 0 (scalar loads), on 16-byte-aligned inputs and on
    copies 4 bytes off (scalar loads again), at 1x1 and 8x8 (one mip level)
    and at 640x480 (eight levels, the last block's shared-memory tail); both
    distances, share margin on and off, mip and color table in one launch."""
    from tracking_sdf_tpu_torch.fusion import brick

    k567 = _k567()
    h, w = hw
    cam, pts, nrm, rgb = _random_frame(dev, h, w, seed=h * w)
    assert k567.aligned16(pts, nrm, rgb)
    for distance in ("point_to_plane", "point_to_point"):
        for share in (0.0, 0.0625):
            want_mip = brick._zeta_mip_reference(pts, nrm, cam, PARAMS.delta, distance, share)
            want_pix = brick._pixel_table_reference(pts, nrm, rgb, True, distance)
            for p, n, c in ((pts, nrm, rgb), tuple(_unaligned(x) for x in (pts, nrm, rgb))):
                mip, pix = brick.frame_tables(p, n, c, True, cam, PARAMS.delta, distance, share)
                assert _bits_equal(pix, want_pix), (distance, share, p.data_ptr() % 16)
                assert mip.offsets == want_mip.offsets and mip.dims == want_mip.dims
                for name in ("zeta", "zeta_down", "eta", "eta_down"):
                    assert _bits_equal(getattr(mip, name), getattr(want_mip, name)), (
                        name, distance, share, p.data_ptr() % 16)


# --- K1's central form on tum256central's rows ---------------------------------

_CENTRAL = {}


def _central_handheld(dev):
    """tum256central's bf16 rows (256^3) on the card after three 640x480
    frames of a sphere, a box and a wall seen moving 14 mm a frame (the
    handheld traffic's pace), the fourth frame's points at pixel_stride,
    and poses to track them from: the tracked pose, one moved 2 cm and
    1 degree, and one lowered 1.2 m, so that the points below the grid's
    low z face drop out and those astride it lose some probes."""
    if "case" not in _CENTRAL:
        import dataclasses

        from tracking_sdf_tpu_torch.config import preset
        from tracking_sdf_tpu_torch.core.camera import ros_default_camera
        from tracking_sdf_tpu_torch.core.lie import Pose
        from tracking_sdf_tpu_torch.fusion.brickmajor import brick_rows_view
        from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

        cfg = dataclasses.replace(preset("tum256central"), trajectory_path=None)
        cam = ros_default_camera()
        scene = _Union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                       CuboidScene(min_corner=(-0.75, -0.4, -0.55),
                                   max_corner=(-0.35, 0.4, 0.15)),
                       CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0)))
        poses = [look_at((0.3 + 0.014 * i, -2.4, 0.15), (0.0, 0.0, 0.0), device=dev)
                 for i in range(4)]
        depths = [render_scene_depth(scene, cam, p) for p in poses]
        r = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
        for k in range(3):
            r.process_frame(depths[k], timestamp=float(k))
        assert not any(s.rejected for s in r.stats)
        pts = preprocess_frame(depths[3], cam=cam, bilateral=cfg.bilateral_filter,
                               bilateral_mode=cfg.bilateral_mode)[0]
        s = cfg.tracking.pixel_stride
        turn = se3_exp(torch.tensor([0.012, -0.01, 0.008, 0.01, -0.012, 0.008], device=dev))
        tracked = Pose(r.pose.R.clone(), r.pose.t.clone())
        bg = r.brick_grid
        _CENTRAL["case"] = (cfg, bg, brick_rows_view(bg, cfg.grid, cfg.fusion.brick_shape),
                            pts[::s, ::s], {
                                "tracked": tracked,
                                "moved": Pose(turn.R @ tracked.R, turn.R @ tracked.t + turn.t),
                                "edge": Pose(tracked.R, tracked.t + torch.tensor(
                                    [0.0, 0.0, -1.2], device=dev))})
        r.close()
    return _CENTRAL["case"]


@pytest.mark.parametrize("case", ["tracked", "moved", "edge"])
def test_gn_central_step_is_central_step_reference_bitwise(dev, case):
    """Over a level of tum256central (20 launches, the done flag freezing the
    state), each launch of K1's central form leaves the state that its
    plain version (the 13-probe terms of pixel_residuals_central on the
    card, sums_in_launch_order, gn_finish) leaves, bit for bit; the strided
    (h, w, 3) view of the points is read in place."""
    from tracking_sdf_tpu_torch.grid.grid import world_to_voxel
    from tracking_sdf_tpu_torch.tracking.gauss_newton import pixel_residuals_central

    cfg, _, rows, pts, poses = _central_handheld(dev)
    tc, params = cfg.tracking, cfg.grid
    pose = poses[case]
    flat = pts.reshape(-1, 3)
    _, _, mask = pixel_residuals_central(rows, pose, flat, params=params)
    uvw = world_to_voxel(params, flat @ pose.R.T + pose.t)
    inside = ((uvw >= 0) & (uvw < params.m)).all(-1)
    finite = torch.isfinite(flat).all(-1)
    assert int(mask.sum()) > (1000 if case == "edge" else 5000)
    if case == "edge":
        assert int((finite & ~inside).sum()) > 1000  # below the grid's low face
        assert int((finite & inside & ~mask).sum()) > 0  # a probe out of the grid
    sk = k1.init_state(pose, tc.damping)
    sr = sk.clone()
    step = k1.central_stepper(rows, sk, pts, params, tc)
    before = k1.launches_step_central
    for i in range(tc.max_iterations):
        k1.central_step_reference(rows, sr, pts, params, tc)
        step()
        torch.cuda.synchronize()
        assert _same_bits(sk, sr), (case, i, (sk - sr).abs().max().item())
    assert k1.launches_step_central == before + tc.max_iterations
    assert int(sk.view(torch.int32)[k1.S_COUNT]) >= 2


def test_gn_step_on_the_central_rows_is_still_gn_finish_of_the_plain_terms(dev):
    """The analytic gn_step on the same 256^3 bf16 rows and points: each
    launch leaves gn_finish's state on the plain terms summed in launch
    order, bit for bit, as before K1's central form shared its reduce
    half."""
    cfg, bg, _, pts, poses = _central_handheld(dev)
    params, bs = cfg.grid, cfg.fusion.brick_shape
    view = brick_masked_view(bg, params, bs)
    tc = cfg.tracking._replace(jacobian="analytic", max_iterations=6)
    sk = k1.init_state(poses["moved"], tc.damping)
    sf = sk.clone()
    step, finish = k1.gn_stepper(view, sk, pts, params, tc), k1.finisher(sf, tc)
    for _ in range(tc.max_iterations):
        finish(k1.sums_in_launch_order(k1.query_terms_reference(view, sf, pts.reshape(-1, 3),
                                                                params)))
        step()
        torch.cuda.synchronize()
        assert _same_bits(sk, sf)
    assert int(sk.view(torch.int32)[k1.S_COUNT]) >= 2


def test_central_stepper_rejects_bad_input(dev):
    from tracking_sdf_tpu_torch.grid.interp import BrickRows

    cfg, bg, rows, pts, poses = _central_handheld(dev)
    tc, params = cfg.tracking, cfg.grid
    state = k1.init_state(poses["tracked"], tc.damping)
    with pytest.raises(ValueError):
        k1.central_stepper(rows, state, pts.double(), params, tc)
    with pytest.raises(ValueError):  # W in another brick shape
        k1.central_stepper(BrickRows(rows.D, brick_masked_view(bg, params, (16, 8, 4))),
                           state, pts, params, tc)
    dense = torch.zeros(params.m, params.m, params.m, device=dev)
    for bad in (BrickRows(dense, rows.W), BrickRows(rows.D, dense)):  # a dense leaf
        with pytest.raises(ValueError):
            k1.central_stepper(bad, state, pts, params, tc)


@pytest.mark.parametrize("pose_init", ["previous", "velocity"])
def test_central_chunk_replays_match_per_frame_loop(dev, pose_init):
    """tum256central's process_chunk on the card (CUDA-graph replays of the
    central level, 20 launches of K1's central form a frame) equals its
    per-frame loop on the same frames bit for bit, with frame 3 all NaN
    (rejected)."""
    import dataclasses

    import numpy as np

    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    nb = (PARAMS.m // 8) ** 3
    cfg = preset("tum256central")
    cfg = dataclasses.replace(cfg, grid=PARAMS, trajectory_path=None, pose_init=pose_init,
                              fusion=cfg.fusion._replace(brick_cap=4 * nb, brick_cap_free=nb))
    scene = _Union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                   CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    eyes = [(0.02 * i, -1.5, 0.2 + 0.01 * i) for i in range(6)]
    depths, rgbs = [], []
    for i, e in enumerate(eyes):
        d = render_scene_depth(scene, cam, look_at(e, (0, 0, 0), device="cpu")).numpy()
        if i == 3:
            d[:] = np.nan
        depths.append(np.where(np.isfinite(d), np.round(d * 5000.0), 0).astype(np.uint16))
        rgbs.append(np.full((72, 96, 3), 40 * i, np.uint8))
    p0 = look_at(eyes[0], (0, 0, 0), device=dev)
    seq = Reconstruction(cam, cfg, initial_pose=p0, device=dev)
    for i in range(6):
        seq.process_frame(depths[i], rgbs[i], timestamp=float(i))
    chk = Reconstruction(cam, cfg, initial_pose=p0, device=dev)
    chk.chunk_phase_metrics = False
    chk.process_frame(depths[0], rgbs[0], timestamp=0.0)
    before = (k1.launches_step_central, k1.launches_step_brick, brick_fuse.launches)
    stats = chk.process_chunk(np.stack(depths[1:]), np.stack(rgbs[1:]))
    assert (k1.launches_step_central - before[0], k1.launches_step_brick - before[1],
            brick_fuse.launches - before[2]) == (5 * cfg.tracking.max_iterations, 0, 5)
    assert [(s.rejected, s.gn_iterations, s.num_valid, s.mean_abs_residual) for s in stats] == [
        (s.rejected, s.gn_iterations, s.num_valid, s.mean_abs_residual)
        for s in seq.stats[1:]]
    assert stats[2].rejected and sum(s.rejected for s in stats) == 1
    assert sum(s.gn_iterations for s in stats) > 4
    assert torch.equal(chk.pose.R, seq.pose.R) and torch.equal(chk.pose.t, seq.pose.t)
    for k in ("D", "W", "C"):
        a, b = getattr(chk.brick_grid, k), getattr(seq.brick_grid, k)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
