"""K2's fused row form (fusion/brick_fuse.py) on the CPU.

``brick_fuse_rows_reference``, the plain version that the CUDA kernel is held
to on the card, against the unfused pair it replaces on the main path
(``brick._full_brick_updates``, stacked, then
``brick_merge.brick_merge_rows_reference``): bitwise on every stored non-NaN
value, with equal NaN masks. Inputs are a real frame's FULL and FREE lists
(sphere + box + wall scene, 96x72 camera, m = 64) with padding slots in both
lists and FULL bricks past the cap, over random stored rows (unobserved
voxels, weights at the clamp). The wrapper's validation runs before its
device branch, so the CPU pins it. The port against the JAX package through
``fuse_frame_brickmajor`` is in test_torch_brickmajor.py.
"""
import pytest
import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu_torch.fusion import brick_fuse, brick_merge
from tracking_sdf_tpu_torch.fusion.brick import _full_brick_updates, _pixel_table
from tracking_sdf_tpu_torch.fusion.brickmajor import classify_compact_rows, pack_color
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

torch.set_num_threads(2)

PARAMS = GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
# narrow enough that the wall's bricks straddle the image's top and bottom
CAM = PinholeCamera(fx=80.0, fy=80.0, cx=47.5, cy=35.5, width=96, height=72)
BS = (8, 8, 8)
NB = (64 // 8) ** 3
BV = 512
CAP, CAP_FREE = 96, 64
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Scene:
    parts = (SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
             CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)),
             CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0)))

    def intersect(self, o, d):
        t = self.parts[0].intersect(o, d)
        for s in self.parts[1:]:
            tb = s.intersect(o, d)
            t = torch.where(torch.isnan(t), tb,
                            torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))
        return t


def _cfg(**kw):
    base = FusionConfig(mode="brickmajor", brick_shape=BS, pixel_share=4, pixel_share_j=4,
                        distance="point_to_point", free_fold=True,
                        storage_dtype="bfloat16", weight_dtype="bfloat16",
                        max_weight=128.0)
    return base._replace(**kw)


def _split_groups(rows, pose):
    """Bricks ``rows`` one of whose 4x4 share groups has its centre voxel
    outside the image and another voxel inside: such a voxel reads the
    centre's clamped pixel row."""
    I0, J0, K0 = brick_fuse._brick_origins(rows, PARAMS.m, BS)
    ar = torch.arange(8)
    ins = brick_fuse._project(pose, PARAMS, CAM, (CAM.height, CAM.width),
                              I0 + ar[:, None, None], J0 + ar[:, None], K0 + ar)[4]
    g = ins.expand(-1, 8, 8, 8).reshape(-1, 8, 2, 4, 2, 4)
    return (~g[:, :, :, 2, :, 2] & g.any(dim=5).any(dim=3)).flatten(1).any(1)


def _frame(cfg):
    """Points, normals, colors, pose, the listed ids and the FULL bricks left
    past the cap. The FULL list takes the bricks with split share groups
    first, then the others in id order, with two slots padded; the FREE
    list ends in padding."""
    pose = look_at((0.3, -2.4, 0.15), (0.0, 0.0, 0.0), device="cpu")
    depth = render_scene_depth(Scene(), CAM, pose)
    depth[30:40, 10:25] = float("nan")
    pts, nrm = preprocess_frame(depth, cam=CAM, bilateral=False)
    rgb = torch.rand(CAM.height, CAM.width, 3,
                     generator=torch.Generator().manual_seed(5))
    ids, counts = classify_compact_rows(PARAMS, pose, pts, nrm, cam=CAM, cfg=cfg, bs=BS,
                                        cap=NB, cap_free=NB)
    n_full, n_free = int(counts[0]), int(counts[1])
    assert n_full > CAP + 10 and n_free > 10
    full = ids[:n_full]
    split = _split_groups(full.long(), pose)
    full = torch.cat([full[split], full[~split]])
    listed, past_cap = full[:CAP].clone(), full[CAP:]
    listed[[3, 40]] = NB
    free = ids[NB:][:CAP_FREE].clone()
    free[min(n_free, CAP_FREE) - 5:] = NB
    return pts, nrm, rgb, pose, torch.cat([listed, free]), past_cap


def _rows(vdt, wdt, seed=3):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    W = rand(NB, BV, lo=-20.0, hi=140.0).clamp(0.0, 128.0)
    D = torch.where(W > 0, rand(NB, BV, lo=-0.15, hi=0.15), float("nan"))
    C = pack_color(*(rand(NB, BV).to(vdt) for _ in range(3)),
                   rand(NB, BV, lo=0.0, hi=140.0).clamp(max=128.0).to(wdt))
    return [D.to(vdt), W.to(wdt), C]


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _assert_same(a, b):
    """Equal storage bits on every non-NaN value, equal NaN masks."""
    for x, y, name in zip(a, b, ("D", "W", "C")):
        if x.is_floating_point():
            nan = torch.isnan(y)
            assert torch.equal(torch.isnan(x), nan), name
            x, y = x[~nan], y[~nan]
        assert torch.equal(_bits(x), _bits(y)), name


CASES = [  # distance, weighting, color, value / weight storage, pixel share
    ("point_to_point", "exponential", True, "bfloat16", "bfloat16", 4),
    ("point_to_point", "exponential", False, "bfloat16", "bfloat16", 4),
    ("point_to_plane", "exponential", True, "bfloat16", "bfloat16", 4),
    ("point_to_point", "linear", True, "bfloat16", "bfloat16", 4),
    ("point_to_plane", "narrow_linear", True, "float32", "float32", 4),
    ("point_to_point", "constant", False, "float32", "float32", 1),
    ("point_to_plane", "narrow_exponential", True, "bfloat16", "float32", 1),
    ("point_to_point", "linear", True, "float32", "bfloat16", 2),
]


@pytest.mark.parametrize("distance,wname,color,vdt,wdt,share", CASES)
def test_reference_matches_unfused_pair(distance, wname, color, vdt, wdt, share):
    cfg = _cfg(distance=distance, weighting=wname, pixel_share=share, pixel_share_j=share)
    pts, nrm, rgb, pose, ids, past_cap = _frame(cfg)
    pix = _pixel_table(pts, nrm, rgb if color else None, color, distance)
    hw = (CAM.height, CAM.width)
    new = _rows(DTYPES[vdt], DTYPES[wdt])
    old = [x.clone() for x in new]
    before = [x.clone() for x in new]

    launches = (brick_fuse.launches, brick_merge.launches_rows)
    brick_fuse.brick_fuse_rows(*new, ids, pix, pose, cap=CAP, hw=hw, params=PARAMS,
                               cam=CAM, cfg=cfg, bs=BS)
    assert (brick_fuse.launches, brick_merge.launches_rows) == launches  # CPU: plain
    upd = torch.stack(_full_brick_updates(ids[:CAP], pix, pose, PARAMS, CAM, cfg, BS, hw,
                                          color), dim=0)
    brick_merge.brick_merge_rows_reference(*old, upd.reshape(upd.shape[0], CAP, -1), ids,
                                           cap=CAP, delta=PARAMS.delta,
                                           max_weight=cfg.max_weight)
    _assert_same(new, old)

    # the inputs reach what they are meant to reach
    listed = ids[ids < NB].long()
    changed = (_bits(new[0]) != _bits(before[0])).any(1) | (new[1] != before[1]).any(1)
    assert changed[listed].any() and not changed[past_cap.long()].any()
    assert (new[1].float() == 128.0).any()
    color_rows = (new[2] != before[2]).any(1)
    assert color_rows.any() if color else not color_rows.any()


def test_listed_full_bricks_hold_split_share_groups():
    """Some listed FULL brick has a share group whose centre voxel lies
    outside the image while another of its voxels lies inside, so
    test_reference_matches_unfused_pair covers the clamped centre row."""
    _, _, _, pose, ids, _ = _frame(_cfg())
    rows = ids[:CAP][ids[:CAP] < NB].long()
    assert _split_groups(rows, pose).sum() >= 3


def _args(**over):
    vdt = wdt = torch.bfloat16
    D, W, C = _rows(vdt, wdt)
    pose = look_at((0.3, -2.4, 0.15), (0.0, 0.0, 0.0), device="cpu")
    a = dict(D=D, W=W, C=C, ids=torch.full((CAP + CAP_FREE,), NB, dtype=torch.int32),
             pix=torch.zeros(CAM.height * CAM.width, 8), pose=pose, cap=CAP,
             hw=(CAM.height, CAM.width), params=PARAMS, cam=CAM, cfg=_cfg(), bs=BS)
    a.update(over)
    return a


BAD = {
    "D dtype": dict(D=torch.zeros(NB, BV, dtype=torch.float64)),
    "W shape": dict(W=torch.zeros(NB, BV // 2, dtype=torch.bfloat16)),
    "C width": dict(C=torch.zeros(NB, 3 * BV, dtype=torch.int16)),
    "ids dtype": dict(ids=torch.full((CAP + CAP_FREE,), NB, dtype=torch.int64)),
    "ids shorter than cap": dict(ids=torch.full((CAP - 1,), NB, dtype=torch.int32)),
    "table channels": dict(pix=torch.zeros(CAM.height * CAM.width, 5)),
    "table rows": dict(pix=torch.zeros(CAM.height * CAM.width - 1, 8)),
    "pose dtype": dict(pose=look_at((0.3, -2.4, 0.15), (0.0, 0.0, 0.0),
                                    device="cpu").to(torch.float64)),
    "weighting": dict(cfg=_cfg(weighting="quadratic")),
    "distance": dict(cfg=_cfg(distance="point_to_line")),
    "odd k extent": dict(bs=(32, 16, 1)),  # same NB and BV as (8, 8, 8)
}


def _call(args):
    rows = [args.pop(k) for k in ("D", "W", "C", "ids", "pix", "pose")]
    brick_fuse.brick_fuse_rows(*rows, **args)
    return rows[:3]


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrapper_rejects_bad_input(what):
    with pytest.raises(ValueError):
        _call(_args(**BAD[what]))


def test_wrapper_all_padding_changes_nothing():
    args = _args()
    before = [args[k].clone() for k in ("D", "W", "C")]
    _assert_same(_call(args), before)
