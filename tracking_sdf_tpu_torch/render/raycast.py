"""Differentiable sphere-tracing raycaster over the TSDF grid (counterpart of
tracking_sdf_tpu.render.raycast, single device).

Rays are clipped to the grid's box, then march in lockstep: finished rays
are masked, never branched on. The default ``sample="nearest_far"`` steps
on the nearest voxel's value less a Lipschitz margin (sqrt(3)/2 voxels, so a
step cannot cross the surface) until a ray is within ``fine_threshold``
voxels of it; a Newton finish on the trilinear field (``fine_mode``
"newton", or a short trilinear march with "march") then lands on the
crossing. Rays still alive after that (grazers) march on in a compacted
batch of K slots (``two_phase``): the first K alive rays in ray order get a
slot, the rest are reported in ``dropped`` and render as misses.
``sample="trilinear"`` marches on the trilinear field from the start.

The march runs without gradients. The returned range applies one implicit
Newton step t* = t - phi(o + t u) / (grad phi . u) on the masked trilinear
field, through which autograd carries d t* / d(pose.R, pose.t, grid.D).

A dead ray's state is a fixed point of a march step (t, hit and steps stay
as they are, and t >= t_lo), so the loops test whether any ray is alive
only every ``_ANY_EVERY`` steps, one host read each time, and stop at the
same state as a test after every step would.

Two optional leaps, off by default, save steps (the JAX package's
conditions decide where they apply: m a multiple of 8 with (m/8)^3 a
multiple of 128); a ray hits what the plain march hits, at the same depth,
but for grazing rays and rays on which the plain march itself steps past a
crossing of a truncated field (tests/test_torch_raycast_skip.py):
  * ``empty_skip``: an L-inf chamfer distance s (capped at 8) from each 8^3
    brick to the nearest brick with an observed voxel (W > 0); a sample in
    unobserved space may step (s - 1) brick extents, every march;
  * ``far_field="chamfer"`` (the nearest march only): the same distance to
    the nearest surface-band brick (some D < far_band * delta); any sample
    may leap (s - 1) brick extents less one voxel cell's diagonal, because a
    trilinear crossing can reach one cell beyond its band brick.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import math

import torch

from tracking_sdf_tpu_torch.config import GridParams, RaycastConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera, pixel_rays
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid, world_to_voxel
from tracking_sdf_tpu_torch.grid.interp import (
    interp_color, masked_view, trilinear_nan, trilinear_with_grad, trilinear_with_grad_nan)

_ANY_EVERY = 8  # march steps between two tests for a live ray
_LIPSCHITZ_MARGIN = 0.8660254  # sqrt(3)/2 voxels: nearest voxel centre to a point
_SKIP_B = 8  # leap mip brick side, voxels (independent of fusion's bricks)
_SKIP_K = 8  # chamfer iterations: the longest leap, in bricks


class RenderResult(NamedTuple):
    depth: torch.Tensor  # (H, W) z-depth in the camera frame; NaN on a miss
    range_t: torch.Tensor  # (H, W) distance along the ray; NaN on a miss
    hit: torch.Tensor  # (H, W) bool
    normal_world: torch.Tensor  # (H, W, 3); NaN on a miss
    normal_cam: torch.Tensor  # (H, W, 3); NaN on a miss
    rgb: Optional[torch.Tensor]  # (H, W, 3) in [0, 1], or None
    steps: torch.Tensor  # (H, W) int32 march steps taken
    dropped: Union[torch.Tensor, int] = 0  # rays past the compacted phase's slots


def _ray_box(origin, unit, lo, hi):
    """Entry and exit distances of the rays o + t*u through an axis-aligned box."""
    safe_u = torch.where(unit.abs() < 1e-12, torch.full_like(unit, 1e-12), unit)
    t0 = (lo - origin) / safe_u
    t1 = (hi - origin) / safe_u
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v for (..., 3) vectors, as float32 products and sums (no TF32)."""
    return torch.sum(R * v[..., None, :], dim=-1)


def _min_pool3(t: torch.Tensor) -> torch.Tensor:
    """3x3 min-pool of an (H, W) image with +inf outside, axis by axis."""
    big = torch.full_like(t[:1], float("inf"))
    pooled = torch.minimum(t, torch.minimum(torch.cat([t[1:], big]), torch.cat([big, t[:-1]])))
    big = torch.full_like(pooled[:, :1], float("inf"))
    return torch.minimum(pooled, torch.minimum(torch.cat([pooled[:, 1:], big], dim=1),
                                               torch.cat([big, pooled[:, :-1]], dim=1)))


def _chamfer(occ: torch.Tensor) -> torch.Tensor:
    """L-inf chamfer distance (capped at _SKIP_K) to the nearest True cell of
    an (nb, nb, nb) bool grid: _SKIP_K - 1 separable 3^3 min-pools."""
    nb = occ.shape[0]
    dist = torch.where(occ, 0, _SKIP_K).to(torch.int32)
    for _ in range(_SKIP_K - 1):
        a = dist
        for ax in range(3):
            pad = [0, 0] * 3
            pad[2 * (2 - ax):2 * (2 - ax) + 2] = [1, 1]
            p = torch.nn.functional.pad(a, pad, value=_SKIP_K)
            a = torch.minimum(torch.minimum(p.narrow(ax, 0, nb), p.narrow(ax, 1, nb)),
                              p.narrow(ax, 2, nb))
        dist = torch.minimum(dist, a + 1)
    return dist


def _brick_occupancy(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """Per 8^3 brick of an (m, m, m) grid: its max (or min) value."""
    nb = x.shape[0] // _SKIP_B
    x = x.reshape(nb, _SKIP_B, nb, _SKIP_B, nb, _SKIP_B)
    return x.amax(dim=(1, 3, 5)) if largest else x.amin(dim=(1, 3, 5))


def _skip_mip(W: torch.Tensor) -> torch.Tensor:
    """Chamfer distance to the nearest 8^3 brick with an observed voxel: a
    ray in unobserved space at distance s >= 2 cannot reach observed space
    within s - 1 bricks."""
    return _chamfer(_brick_occupancy(W, largest=True) > 0)


def _band_skip_mip(Dm: torch.Tensor, params: GridParams, band_frac: float) -> torch.Tensor:
    """Chamfer distance to the nearest surface-band 8^3 brick: one with a
    voxel whose D is below band_frac * delta (NaN, unobserved, is not)."""
    Dv = torch.where(torch.isnan(Dm), float("inf"), Dm)
    return _chamfer(_brick_occupancy(Dv, largest=False) < band_frac * params.delta)


def _leap(mip: torch.Tensor, uvw: torch.Tensor, extent: float) -> torch.Tensor:
    """(s - 1) * extent at the mip brick of each voxel coordinate."""
    nb = mip.shape[0]
    b = (uvw / _SKIP_B).to(torch.int64).clamp(0, nb - 1)
    s = mip.reshape(-1)[(b[:, 0] * nb + b[:, 1]) * nb + b[:, 2]]
    return (s - 1).to(uvw.dtype) * extent


def raycast(grid: TSDFGrid, pose: Pose, *, params: GridParams, cam: PinholeCamera,
            cfg: RaycastConfig = RaycastConfig(), stride: int = 1,
            with_color: bool = False, t_init: Optional[torch.Tensor] = None,
            dirs_cam: Optional[torch.Tensor] = None) -> RenderResult:
    """Render depth, range, normals and (``with_color``) color of the grid
    from ``pose`` on the grid's device. ``t_init``: a previous render's
    ``range_t`` (NaN = miss) to start each ray near its surface: a 3x3
    min-pool of it less ``warm_backoff`` (default delta); rays with no prior
    start cold. ``dirs_cam`` (h, w, 3) camera-frame directions with z = 1
    replace ``pixel_rays(cam, stride)``; a ray whose direction is not finite
    is dead from the start (it never marches and renders as a miss)."""
    dev = grid.D.device
    dtype = grid.D.dtype
    delta = params.delta
    miss_step = cfg.miss_step if cfg.miss_step > 0 else delta / 2
    if dirs_cam is None:
        dirs_cam, _ = pixel_rays(cam, stride, device=dev)
    dead = ~torch.isfinite(dirs_cam).all(dim=-1)
    d_world = _rotate(pose.R, torch.where(dead[..., None], 1.0, dirs_cam))
    dn = torch.linalg.norm(d_world, dim=-1, keepdim=True)
    unit = d_world / dn
    origin = pose.t
    shape = unit.shape[:-1]
    N = unit[..., 0].numel()

    with torch.no_grad():
        Dm = masked_view(grid.D.detach(), grid.W)
        o = origin.detach()
        unit_f = unit.detach().reshape(N, 3)
        lo = torch.tensor(params.origin, dtype=dtype, device=dev)
        hi = lo + torch.tensor(params.extent, dtype=dtype, device=dev)
        t_enter, t_exit = _ray_box(o, unit_f, lo, hi)
        t_start_f = torch.clamp(t_enter, min=cfg.t_near)
        t_stop_f = torch.clamp(t_exit, max=cfg.t_far)
        alive0 = (t_start_f < t_stop_f) & ~dead.reshape(N)  # it meets the volume at all

        if t_init is not None:
            backoff = cfg.warm_backoff if cfg.warm_backoff > 0 else delta
            ti = torch.as_tensor(t_init, device=dev).to(
                torch.promote_types(dtype, torch.float32)).reshape(shape)
            pooled = _min_pool3(torch.where(torch.isfinite(ti), ti,
                                            torch.full_like(ti, float("inf"))))
            warm = torch.isfinite(pooled).reshape(N)
            t_warm = torch.clamp(pooled.reshape(N) - backoff, min=0.0)
            t_start_f = torch.where(warm, torch.maximum(t_start_f, t_warm), t_start_f)
            t_start_f = torch.minimum(t_start_f, t_stop_f)

        def points(t, u):
            return world_to_voxel(params, o + t[:, None] * u)

        m = params.m
        mip_ok = m % _SKIP_B == 0 and (m // _SKIP_B) ** 3 % 128 == 0
        brick_ext = _SKIP_B * min(params.width, params.height, params.depth) / m
        skip = _skip_mip(grid.W) if cfg.empty_skip and mip_ok else None

        def loop(body, state, budget):
            """Run ``body`` ``budget`` times or until no ray is alive
            (state[2]), testing every _ANY_EVERY steps."""
            for k in range(budget):
                if k % _ANY_EVERY == 0 and not bool(state[2].any()):
                    break
                state = body(state)
            return state

        def march(state, u, t_lo, t_hi, budget):
            """Trilinear sphere tracing: state (t, hit, alive, steps)."""
            def body(s):
                t, hit, alive, steps = s
                uvw = points(t, u)
                phi, ok = trilinear_nan(Dm, uvw)
                hit_now = alive & ok & (phi.abs() < cfg.hit_epsilon)
                step = torch.where(ok, phi * cfg.step_scale, miss_step).clamp(-delta, delta)
                if skip is not None:  # unobserved: leap, past the band's cap
                    step = torch.where(ok, step, torch.maximum(step, _leap(skip, uvw, brick_ext)))
                t_new = torch.maximum(torch.where(alive & ~hit_now, t + step, t), t_lo)
                return (t_new, hit | hit_now, alive & ~hit_now & ~(t_new > t_hi),
                        steps + alive.to(torch.int32))
            return loop(body, state, budget)

        # the JAX package's condition, kept: it decides which march runs
        nearest_ok = cfg.sample == "nearest_far" and m ** 3 % 128 == 0
        band = (_band_skip_mip(Dm, params, cfg.far_band)
                if cfg.far_field == "chamfer" and nearest_ok and mip_ok else None)
        cell_diag = math.sqrt(sum(v * v for v in params.voxel_size))
        steps0 = torch.zeros(N, dtype=torch.int32, device=dev)
        hit0 = torch.zeros(N, dtype=torch.bool, device=dev)
        tp = cfg.two_phase
        if nearest_ok:
            h_max = max(params.width, params.height, params.depth) / m
            t_fine, margin = cfg.fine_threshold * h_max, _LIPSCHITZ_MARGIN * h_max

            def body_n(s):
                """Nearest-voxel steps; a ray freezes ("near") under t_fine."""
                t, near, alive, steps = s
                uvw = points(t, unit_f)
                n = torch.round(uvw).clamp(0, m - 1).to(torch.int64)
                phi = Dm[n[:, 0], n[:, 1], n[:, 2]].to(t.dtype)
                ok = torch.isfinite(phi)
                near_now = alive & ok & (phi < t_fine)
                step = torch.where(ok, torch.clamp(phi - margin, min=0.0) * cfg.step_scale,
                                   miss_step).clamp(max=delta)
                if skip is not None:
                    step = torch.where(ok, step, torch.maximum(step, _leap(skip, uvw, brick_ext)))
                if band is not None:  # observed or not; one cell short of the band
                    step = torch.maximum(step, _leap(band, uvw, brick_ext) - cell_diag)
                t_new = torch.maximum(torch.where(alive & ~near_now, t + step, t), t_start_f)
                return (t_new, near | near_now, alive & ~near_now & ~(t_new > t_stop_f),
                        steps + alive.to(torch.int32))

            t_m, near, alive_n, steps = loop(body_n, (t_start_f, hit0, alive0, steps0),
                                             cfg.max_steps)
            if cfg.fine_mode == "newton":
                # frozen rays lie within ~fine_threshold voxels of the
                # crossing: a few Newton iterations on the trilinear field;
                # grazers stay un-hit for the compacted march below
                act0 = near | alive_n
                n_iter = max(2, cfg.fine_steps // 3)
                scale_v = torch.tensor([m / params.width, m / params.height,
                                        m / params.depth], dtype=dtype, device=dev)
                hit = hit0
                for _ in range(n_iter):
                    phi, g_uvw, ok = trilinear_with_grad_nan(Dm, points(t_m, unit_f))
                    denom = torch.sum(g_uvw * scale_v * unit_f, dim=-1)
                    hit_now = ok & (phi.abs() < cfg.hit_epsilon)
                    good = act0 & ok & ~hit & ~hit_now & (denom.abs() > 1e-6)
                    step = (phi / torch.where(good, denom, 1.0)).clamp(-delta, delta)
                    t_m = torch.clamp(torch.where(good, t_m - step, t_m), t_start_f, t_stop_f)
                    hit = hit | (act0 & hit_now)
                # a final hit test at the converged t
                phi, ok = trilinear_nan(Dm, points(t_m, unit_f))
                hit = hit | (act0 & ok & (phi.abs() < cfg.hit_epsilon))
                alive = act0 & ~hit
                steps = steps + n_iter * act0.to(torch.int32)
            else:
                t_m, hit, alive, steps = march((t_m, hit0, near | alive_n, steps),
                                               unit_f, t_start_f, t_stop_f, cfg.fine_steps)
            two_phase = N >= 4096 if tp == "auto" else tp == "on"
            budget_a = cfg.max_steps - cfg.max_steps // 2  # the recovery budget
            k_div = 16
        else:
            two_phase = (N >= 4096 if tp == "auto" else tp == "on") and cfg.max_steps > 20
            budget_a = 20 if two_phase else cfg.max_steps
            k_div = 4
            t_m, hit, alive, steps = march((t_start_f, hit0, alive0, steps0),
                                           unit_f, t_start_f, t_stop_f, budget_a)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        if two_phase:
            # the first K alive rays in ray order, with no host read
            K = -(-max(1024, N // k_div) // 128) * 128
            rank = torch.cumsum(alive.to(torch.int64), dim=0) - 1
            slot = torch.where(alive & (rank < K), rank, K)
            idx = torch.full((K + 1,), N, dtype=torch.int64, device=dev)
            idx[slot] = torch.arange(N, device=dev)  # slot K collects the rest
            idx = idx[:K]
            slot_ok = idx < N
            safe = torch.where(slot_ok, idx, 0)
            t_c, hit_c, _, steps_c = march(
                (t_m[safe], hit[safe] & slot_ok, slot_ok,
                 torch.zeros(K, dtype=torch.int32, device=dev)),
                unit_f[safe], t_start_f[safe], t_stop_f[safe], cfg.max_steps - budget_a)
            tgt = torch.where(slot_ok, idx, N)  # row N is a sink for the empty slots
            t_m = torch.cat([t_m, t_m[:1]]).index_copy(0, tgt, t_c)[:N]
            hit = torch.cat([hit, hit[:1]]).index_copy(0, tgt, hit_c)[:N]
            steps = torch.cat([steps, steps[:1]]).index_add(0, tgt, steps_c)[:N]
            dropped = (alive.sum() - slot_ok.sum()).to(torch.int32)
        t_m = t_m.reshape(shape)
        hit = hit.reshape(shape)
        steps = steps.reshape(shape)

    # implicit-function refinement: the differentiable surface distance
    pos = origin + t_m[..., None] * unit
    phi, g_uvw, ok = trilinear_with_grad(grid.D, grid.W, world_to_voxel(params, pos))
    scale = torch.tensor([params.m / params.width, params.m / params.height,
                          params.m / params.depth], dtype=dtype, device=dev)
    g_world = g_uvw * scale
    denom = torch.sum(g_world * unit, dim=-1)
    big = denom.abs() > 1e-6
    safe_denom = torch.where(big, denom, 1.0)
    # double where: phi is zeroed where unused, so the quotient's partial
    # w.r.t. denom (-phi/denom^2) stays finite under a zero cotangent
    use = hit & ok & big
    phi_s = torch.where(use, phi, 0.0)
    t_refined = torch.where(use, t_m - phi_s / safe_denom, t_m)
    hit = hit & ok

    gn = torch.linalg.norm(g_world, dim=-1, keepdim=True)
    n_world = g_world / torch.clamp(gn, min=1e-12)  # outward: +grad
    # toward the camera (n . view direction < 0)
    n_world = torch.where(torch.sum(n_world * unit, -1, keepdim=True) > 0, -n_world, n_world)
    n_cam = _rotate(pose.R.transpose(0, 1), n_world)

    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    range_t = torch.where(hit, t_refined, nan)
    # divided before the NaN select (t_refined is finite everywhere), so a
    # miss puts no NaN into the division's partial w.r.t. dn, which
    # depends on the rotation
    depth = torch.where(hit, t_refined / dn[..., 0], nan)
    n_world = torch.where(hit[..., None], n_world, nan)
    n_cam = torch.where(hit[..., None], n_cam, nan)

    rgb = None
    if with_color:
        hit_pos = origin + torch.where(hit, t_refined, t_m)[..., None] * unit
        rgb_v, c_ok = interp_color(grid.R, grid.G, grid.B, grid.Wc,
                                   world_to_voxel(params, hit_pos))
        rgb = torch.where((hit & c_ok)[..., None], rgb_v, nan)

    return RenderResult(depth=depth, range_t=range_t, hit=hit, normal_world=n_world,
                        normal_cam=n_cam, rgb=rgb, steps=steps, dropped=dropped)
