"""The plain reference's central-difference tracker
(reference/track_central.py) against the port's central tracker on the
CPU at the small cell's sizes: one step's residuals and sums, on the rows
the port fused from the cell's generated frames and on a seeded field that
reaches the grid's faces; a chain of frames under the cell's limits, with
the control failing them; and the modes that ``check_supported`` admits."""
from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import pytest
import torch

from harness import cell, check, data, traffic as gen
from reference import preprocess, step, track, track_central
from reference.lie import Pose as RPose

SEED = 2 ** 31 + 23
WARM = 3  # frames the port runs before a step or a chain: the bootstrap and two tracked
CHAIN = 6


def _central(cfg: dict, levels) -> dict:
    """The configuration with the central Jacobian and the pyramid ``levels``."""
    cfg = copy.deepcopy(cfg)
    cfg["tracking"]["jacobian"] = "central"
    cfg["pipeline"]["pyramid_levels"] = list(levels)
    return cfg


@pytest.fixture
def central_in_launch_order(small, monkeypatch):
    """The small cell, with the port's central sums added in K1's launch
    order over its own terms (on the CPU it forms them by a matmul), and
    solved as the ``small`` fixture has the card do it."""
    from tracking_sdf_tpu_torch.tracking import gauss_newton as gn, gn_reduce as g

    def sums(grid, pose, points, params, cfg):
        phi, J, mask = gn.pixel_residuals_central(grid, pose, points, params=params,
                                                  v_h=cfg.v_h, w_h=cfg.w_h)
        return g.unpack(g.sums_in_launch_order(track.terms_of(phi, J, mask)))
    monkeypatch.setattr(gn, "central_sums", sums)
    return small


class PortRun:
    """The port run per frame on the generated frames of ``traffic``:
    WARM frames, then its state (rows, pose) is copied, then ``n`` more."""

    def __init__(self, cfg: dict, traffic: dict, n: int):
        from tracking_sdf_tpu_torch.core.camera import PinholeCamera
        from tracking_sdf_tpu_torch.core.lie import Pose as PPose
        from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

        self.cfg = cfg
        self.seq = gen.generate(traffic, cfg["camera"], SEED, "cpu", traffic["chunk"])
        fd, traj = tempfile.mkstemp(prefix="perfbench-central-", suffix=".txt")
        os.close(fd)
        p0 = gen.pose0()
        self.pose0 = p0
        recon = Reconstruction(PinholeCamera(**cfg["camera"]), data.pipeline_config(cfg, traj),
                               initial_pose=PPose(p0.R.clone(), p0.t.clone()), device="cpu")
        self.recon = recon
        rejected, counts, iters = [], [], []
        try:
            for k in range(WARM + n):
                if k == WARM:
                    self.before = self.rows()
                    self.pose = RPose(recon.pose.R.clone(), recon.pose.t.clone())
                    self.frame_num = recon.frame_num
                st = recon.process_frame(self.seq.depth[k], self.seq.rgb[k], timestamp=k + 1)
                if k == 0:
                    bg = recon.brick_grid
                    nz = torch.nonzero((bg.W > 0).any(1)).reshape(-1)
                    self.start_rows = (nz, bg.D[nz].clone(), bg.W[nz].clone(), bg.C[nz].clone())
                if k >= WARM:
                    rejected.append(st.rejected)
                    iters.append(st.gn_iterations)
                    counts.append(None if st.rejected else cell._counts(recon.last_fuse_stats))
            if n == 0:
                self.pose = RPose(recon.pose.R.clone(), recon.pose.t.clone())
                return
            self.after = self.rows()
            self.sample = check.Sample(self.before, self.pose, self.frame_num,
                                       self.seq.depth[WARM:WARM + n], self.seq.rgb[WARM:WARM + n],
                                       self.after, rejected, counts, iters, first_stamp=WARM + 1)
            self.trajectory = check.read_trajectory(traj, self.sample.frames)
        finally:
            recon.close()
            os.unlink(traj)

    def rows(self):
        bg = self.recon.brick_grid
        return bg.D.clone(), bg.W.clone(), bg.C.clone()

    def numbers(self, store: str) -> dict:
        """The cell's seven numbers: of the port against the reference
        stored in the configuration's precision, or (``store`` below it) of
        that precision's reference in the port's place."""
        cfg, own = self.cfg, self.cfg["fusion"]["storage_dtype"]
        ref_start = check.start_leaves(cfg, self.pose0, self.seq.depth[0], self.seq.rgb[0], own,
                                       "cpu")
        ref = check.reference_outputs(cfg, self.sample, own)
        if store == own:
            out = check.compare_start(cfg, self.start_rows, ref_start)
            out.update(check.compare(check.program_outputs(self.sample, self.trajectory), ref,
                                     self.sample.frames))
            return out
        c_start = check.start_leaves(cfg, self.pose0, self.seq.depth[0], self.seq.rgb[0], store,
                                     "cpu")
        d, w, _ = check.grid_gaps(c_start, ref_start, None)
        out = dict(start_d_mm=d * 1e3, start_w=w)
        out.update(check.compare(check.reference_outputs(cfg, self.sample, store), ref,
                                 self.sample.frames))
        return out


def _fused_case(small):
    """(the port's dense view, the reference's leaves, params, cfg, pose,
    points): the rows the port fused over WARM frames, the next frame's
    strided points and the port's pose."""
    cfg, tr, _ = small
    cfg = _central(cfg, (1,))
    run = PortRun(cfg, tr, 0)
    bg = run.recon.brick_grid
    dense = run.recon.grid
    leaves = step.leaves_from_rows(bg.D, bg.W, bg.C, bg.D.shape[1])
    cam = cfg["camera"]
    pts, _ = preprocess.preprocess(preprocess.decode_depth(run.seq.depth[WARM],
                                                           torch.full((), 5000.0)), cam)
    s = cfg["tracking"]["pixel_stride"]
    return dense, leaves, run.recon.config.grid, cfg, run.pose, pts[::s, ::s].reshape(-1, 3)


def _field_case(small):
    """A seeded field over the whole 64^3 grid (a sphere's distance, clipped,
    in bfloat16; a fifth of the voxels unobserved), and points that put
    queries inside, astride each face and outside the grid, and on voxel
    centres (exact hits), at a turned pose."""
    from tracking_sdf_tpu_torch.fusion import brickmajor as bm
    from tracking_sdf_tpu_torch.grid.grid import empty_grid

    cfg, _, _ = small
    cfg = _central(cfg, (1,))
    params = data.pipeline_config(cfg, "t.txt").grid
    bs = tuple(cfg["fusion"]["brick_shape"])
    m = params.m
    gen_ = torch.Generator().manual_seed(SEED)
    g = empty_grid(params, device="cpu")
    ijk = torch.stack(torch.meshgrid(*[torch.arange(m, dtype=torch.float32)] * 3,
                                     indexing="ij"), -1)
    extent = torch.tensor([params.width, params.height, params.depth])
    world = (ijk + 0.5) * extent / m + torch.tensor(params.origin)
    g.D.copy_(((world - torch.tensor([0.0, 0.4, 1.2])).norm(dim=-1) - 1.1).clamp(-0.3, 0.3))
    g.W.copy_(torch.where(torch.rand(m, m, m, generator=gen_) < 0.2, 0.0,
                          torch.randint(1, 60, (m, m, m), generator=gen_).float()))
    bg = bm.brick_grid_from_dense(g, bs, value_dtype=torch.bfloat16, weight_dtype=torch.bfloat16)
    dense = bm.dense_from_brick_grid(bg, params, bs)
    leaves = step.leaves_from_rows(bg.D, bg.W, bg.C, bg.D.shape[1])
    c, s = np.cos(0.3), np.sin(0.3)
    R = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float32)
    pose = RPose(R, torch.tensor([0.2, -0.1, 0.4]))
    uvw = torch.cat([torch.rand(3000, 3, generator=gen_) * (m + 4.0) - 2.0,  # some outside
                     torch.randint(0, m, (800, 3), generator=gen_).float(),  # voxel centres
                     torch.rand(400, 3, generator=gen_) * 2.0 - 0.5,  # astride the low faces
                     m - 1.5 + torch.rand(400, 3, generator=gen_) * 2.0])  # and the high ones
    x = (uvw.double() + 0.5) * extent.double() / m + torch.tensor(params.origin).double()
    pts = ((x - pose.t.double()) @ R.double()).float()
    pts[::97] = float("nan")  # holes
    return dense, leaves, params, cfg, pose, pts


def _both(case, small):
    """The port's (phi, J, mask) and the reference's at the case's pose and
    points, and (leaves, cfg, pose, points, brick shape)."""
    from tracking_sdf_tpu_torch.core.lie import Pose as PPose
    from tracking_sdf_tpu_torch.tracking.gauss_newton import pixel_residuals_central

    dense, leaves, params, cfg, pose, pts = case(small)
    t = cfg["tracking"]
    port = pixel_residuals_central(dense, PPose(pose.R, pose.t), pts, params=params,
                                   v_h=t["v_h"], w_h=t["w_h"])
    bs = tuple(cfg["fusion"]["brick_shape"])
    ref = track_central.residuals((leaves["D"], leaves["W"]), cfg["grid"], bs, pose, pts,
                                  t["v_h"], t["w_h"])
    return port, ref, (leaves, cfg, pose, pts, bs)


CASES = {"fused": _fused_case, "field": _field_case}


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_the_port_residuals(small, case):
    """Masks equal; phi and J of the valid queries within one float32
    rounding of the last op (|gap| <= eps32 * |port's value|): both sides
    run the same float32 operations, and the tolerance lets a value round
    once the other way."""
    (phi, J, mask), (r_phi, r_J, r_mask), (leaves, cfg, pose, pts, bs) = \
        _both(CASES[case], small)
    assert torch.equal(r_mask, mask)
    assert 0 < int(mask.sum()) < mask.numel()
    eps = torch.finfo(torch.float32).eps
    assert ((r_phi - phi).abs() <= eps * phi.abs())[mask].all()
    assert ((r_J - J).abs() <= eps * J.abs())[mask].all()
    if case == "fused":
        return
    m = cfg["grid"]["m"]
    x = pts @ pose.R.T + pose.t
    origin = torch.tensor(cfg["grid"]["origin"])
    scale = torch.tensor([m / cfg["grid"][k] for k in ("width", "height", "depth")])
    uvw = (x - origin) * scale - 0.5
    # exact hits: a value probe on a kept voxel centre returns its D as stored
    near = (uvw - uvw.round()).abs().sum(-1) < 1e-5
    F, inb = track.corner_index(m, bs, uvw.round().to(torch.int64))
    hit = near & inb[:, 0] & (leaves["W"].reshape(-1)[F[:, 0]] > 0) & mask
    assert int(hit.sum()) > 100
    assert torch.equal(r_phi[hit], leaves["D"].reshape(-1)[F[:, 0]][hit])
    # queries astride a face (some probes out of the grid), some of them still valid
    inside = ((uvw >= 0) & (uvw < m)).all(-1)
    astride = inside & ((uvw < 1.0) | (uvw >= m - 1.0)).any(-1)
    assert int((astride & mask).sum()) > 0 and int((astride & ~mask).sum()) > 0
    assert int((~inside & torch.isfinite(pts).all(-1)).sum()) > 0 and not mask[~inside].any()


@pytest.mark.parametrize("case", list(CASES))
def test_the_sums_are_k1s_over_the_port_terms(small, case):
    """The reference's 29 sums (track.sums, K1's launch order) are the
    port's ``sums_in_launch_order`` over the same terms of the port's
    residuals, bit for bit."""
    from tracking_sdf_tpu_torch.tracking import gn_reduce as g

    (phi, J, mask), ref, _ = _both(CASES[case], small)
    assert torch.equal(track.sums(track.terms_of(*ref)),
                       g.sums_in_launch_order(track.terms_of(phi, J, mask)))


@pytest.mark.parametrize("levels", [(1,), (2, 1)], ids=["one_level", "pyramid_2_1"])
def test_a_chain_follows_the_port_within_the_limits(central_in_launch_order, levels):
    cfg, tr, limits = central_in_launch_order
    run = PortRun(_central(cfg, levels), tr, CHAIN)
    numbers = run.numbers(cfg["fusion"]["storage_dtype"])
    assert not any(run.sample.rejected)
    assert check.judge(numbers, limits), {k: (numbers[k], limits[k]) for k in limits}


@pytest.mark.parametrize("levels", [(1,), (2, 1)], ids=["one_level", "pyramid_2_1"])
def test_the_control_of_a_chain_fails_the_limits(central_in_launch_order, levels):
    cfg, tr, limits = central_in_launch_order
    run = PortRun(_central(cfg, levels), tr, CHAIN)
    assert not check.judge(run.numbers("float8_e4m3fn"), limits)


ADMITTED = [("tracking", "jacobian", "analytic"), ("tracking", "jacobian", "central")]
REFUSED = [("tracking", "jacobian", "numeric"), ("tracking", "convergence", "signed"),
           ("tracking", "pose_update", "reference"), ("pipeline", "pose_init", "velocity"),
           ("pipeline", "bilateral_mode", "full"), ("fusion", "sat_skip", True),
           ("fusion", "mode", "packed")]


@pytest.mark.parametrize("group,key,value", ADMITTED + REFUSED,
                         ids=[f"{k}={v}" for _, k, v in ADMITTED + REFUSED])
def test_check_supported_admits_analytic_and_central_only(group, key, value):
    cfg = copy.deepcopy(data.load_json(data.PERFBENCH / "configs" / "tum256.json"))
    cfg[group][key] = value
    if (group, key, value) in ADMITTED:
        step.check_supported(cfg)
    else:
        with pytest.raises(NotImplementedError, match=key):
            step.check_supported(cfg)
