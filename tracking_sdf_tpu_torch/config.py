"""Typed configuration of the port: grid, tracking, fusion, raycast, pipeline.

The same classes, field names, field order, defaults and presets as the JAX
package's ``config.py``, so that the two configurations compare field for
field (``tests/test_torch_config.py``), and one preset of the port's own,
``tum256central``, which tracks by the central Jacobian on the chunked
brick-major path that the JAX package does not run. The port keeps its own copy and
imports nothing of the JAX package. Fields that select TPU-only layouts
stay as fields; the port ignores those that change no output
(``factored_share``, ``march_unroll``) and raises ``NotImplementedError``
on the one mode it does not run, ``FusionConfig(mode="packed")``
(``pipeline.runner.unsupported``). The reasons behind each preset's
settings, measured on the TPU, are in the JAX package's config comments and
BENCHMARKS.md; they are no measurement of the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple


class GridParams(NamedTuple):
    """Static geometry of the TSDF volume: ``m`` voxels per axis over a
    ``width x height x depth`` meter box anchored at ``origin``; ``delta`` /
    ``epsilon`` are the truncation band and the full-weight band of the
    fusion weighting."""

    m: int = 256
    width: float = 6.0
    height: float = 6.0
    depth: float = 3.5
    origin: Tuple[float, float, float] = (-3.0, -3.0, -0.5)
    delta: float = 0.3
    epsilon: float = 0.025

    @property
    def extent(self) -> Tuple[float, float, float]:
        return (self.width, self.height, self.depth)

    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        return (self.width / self.m, self.height / self.m, self.depth / self.m)

    @property
    def n_voxels(self) -> int:
        return self.m ** 3


class TrackingConfig(NamedTuple):
    """Gauss-Newton tracker settings.

    ``jacobian``: "analytic" (trilinear value and exact grid gradient) or
    "central" (the reference's 13-probe scheme).
    ``convergence``: "norm" (max |twist| < max_twist_diff) or "signed" (the
    reference's quirk: all six signed components < threshold).
    ``pose_update``: "se3" (T <- exp(xi)^-1 ∘ T) or "reference" (the
    reference's quirk, t not rotated: R <- Re' R, t <- t - Re' te).
    ``damping``: Marquardt damping, solve (A + damping·diag(A)) x = b, times
    ``damping_decay`` after each iteration. ``min_iterations``: convergence
    may not fire before this many iterations.
    """

    max_iterations: int = 20
    max_twist_diff: float = 0.001
    v_h: float = 1.0  # translation probe step of "central", voxel units
    w_h: float = 0.01  # rotation probe step of "central", radians
    pixel_stride: int = 3
    jacobian: str = "analytic"
    convergence: str = "norm"
    pose_update: str = "se3"
    damping: float = 0.1
    damping_decay: float = 1.0
    min_iterations: int = 0


class FusionConfig(NamedTuple):
    """TSDF fusion settings.

    ``mode``: "dense" (per-voxel reference), "bricked" (brick compaction
    over the flat (m, m, m) layout) or "brickmajor" (the grid stored as
    brick rows; the presets). ``pixel_share`` / ``pixel_share_j``: groups of
    voxels along k / j share one gathered pixel row (1 = exact).
    ``storage_dtype`` / ``weight_dtype``: "float32" or "bfloat16" storage of
    the brick-major value and weight leaves. ``color_every``: fuse color on
    every Nth frame. ``hier_classify``: super-brick factor of the
    hierarchical classification (0/1 = off), bounded by ``cap_mixed``.
    ``free_fold``: FREE rows merged in the FULL pass (bitwise equal).
    ``sat_skip``: brick-major only; FREE bricks whose update is a proven
    bitwise no-op under the max_weight clamp leave the FREE candidates.
    """

    weighting: str = "exponential"
    distance: str = "point_to_plane"
    fuse_color: bool = True
    max_weight: Optional[float] = None  # running-weight clamp (reference: none)
    mode: str = "dense"
    brick_shape: Tuple[int, int, int] = (1, 8, 128)
    brick_cap: int = 6144
    brick_cap_free: int = 0  # FREE-brick row cap for brickmajor (0 = brick_cap)
    brick_merge: str = "xla"  # merge tail of mode="bricked": "xla", "rows" or "pallas"
    brick_cap_active: int = 0  # 0 = auto (4 * brick_cap)
    pixel_share: int = 1
    storage_dtype: str = "float32"
    color_every: int = 1
    pixel_share_j: int = 1
    factored_share: bool = False  # numerically inert HLO-shape knob; ignored
    hier_classify: int = 0
    cap_mixed: int = 2048
    share_safe_classify: bool = True
    weight_dtype: str = "float32"
    free_fold: bool = False
    sat_skip: bool = False


class RaycastConfig(NamedTuple):
    """Sphere-tracing raycaster (render.raycast). ``empty_skip`` and
    ``far_field="chamfer"`` leap through unobserved and far space;
    ``march_unroll`` is kept so that the configs compare field for field,
    and ignored."""

    max_steps: int = 64
    hit_epsilon: float = 1e-3  # meters
    step_scale: float = 0.9
    t_near: float = 0.1
    t_far: float = 10.0
    miss_step: float = 0.0
    sample: str = "nearest_far"
    fine_threshold: float = 1.5
    fine_steps: int = 12
    fine_mode: str = "newton"
    warm_backoff: float = 0.0
    empty_skip: bool = False
    far_field: str = "off"
    far_band: float = 0.75
    march_unroll: int = 4  # bitwise-equal XLA loop knob; ignored
    two_phase: str = "auto"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end runner configuration."""

    grid: GridParams = GridParams()
    tracking: TrackingConfig = TrackingConfig()
    fusion: FusionConfig = FusionConfig()
    raycast: RaycastConfig = RaycastConfig()
    use_groundtruth: bool = False  # fusion-only oracle mode
    bilateral_filter: bool = True
    bilateral_mode: str = "full"  # "full" 2-D kernel or "separable" passes
    trajectory_path: Optional[str] = "trajectory.txt"
    mesh_hz: float = 0.0
    mesh_decimate: int = 0
    mesh_vertex_quant: bool = True
    # coarse-to-fine pyramid: extra decimation factors (coarsest first,
    # ending at 1) multiplied onto tracking.pixel_stride; None = one level
    pyramid_levels: Optional[Tuple[int, ...]] = None
    # tracking-failure gate: a frame whose track ends with fewer valid
    # pixels or a larger mean |residual| is rejected (pose kept, no fusion)
    min_valid_pixels: int = 50
    max_mean_residual: float = 0.25  # meters; <= 0 disables the gate
    pose_init: str = "previous"  # or "velocity" (constant-velocity guess)


def preset(name: str) -> PipelineConfig:
    """Named presets, equal to the JAX package's of the same name, and the
    port's own ``tum256central``, which the JAX package has not."""
    # the reference's own 256^3 volume on the brick-major main path
    tum256 = PipelineConfig(
        grid=GridParams(m=256),
        bilateral_mode="separable",
        fusion=FusionConfig(mode="brickmajor", brick_shape=(8, 8, 8),
                            pixel_share=4, pixel_share_j=4,
                            brick_cap_free=2048,
                            distance="point_to_point",
                            color_every=2, free_fold=True,
                            weight_dtype="bfloat16", max_weight=128.0,
                            storage_dtype="bfloat16"),
        pyramid_levels=(2, 1),
    )
    presets = {
        # single-frame fusion + render, 64^3, synthetic depth
        "synthetic64": PipelineConfig(
            grid=GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                            origin=(-1.0, -1.0, -1.0), delta=0.1, epsilon=0.01),
        ),
        # 10-frame TUM clip, 128^3
        "tum128": PipelineConfig(grid=GridParams(m=128)),
        "tum256": tum256,
        # tum256 tracked as the reference node tracks (CameraTracking(gn_max=20,
        # max_twist_diff=0.001, v_h=1.0, w_h=0.01), pixel stride 3, no
        # pyramid, A x = b solved undamped): the 13-probe central Jacobian on
        # the brick-major rows
        "tum256central": dataclasses.replace(
            tum256,
            tracking=TrackingConfig(max_iterations=20, max_twist_diff=0.001, v_h=1.0,
                                    w_h=0.01, pixel_stride=3, jacobian="central",
                                    convergence="norm", pose_update="se3", damping=0.0),
            pyramid_levels=None,
        ),
        # 512^3 brick-major with hierarchical classification
        "tum512": PipelineConfig(
            grid=GridParams(m=512),
            bilateral_mode="separable",
            fusion=FusionConfig(mode="brickmajor", brick_shape=(8, 8, 8),
                                brick_cap=28672, pixel_share=4,
                                pixel_share_j=4, brick_cap_free=8192,
                                storage_dtype="bfloat16",
                                weight_dtype="bfloat16", max_weight=128.0,
                                distance="point_to_point",
                                color_every=3, free_fold=True,
                                hier_classify=4, cap_mixed=1536),
            pyramid_levels=(4, 2, 1),
        ),
    }
    return presets[name]
