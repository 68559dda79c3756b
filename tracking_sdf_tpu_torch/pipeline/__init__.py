"""Trajectory I/O and metrics, the realtime pacers and the end-to-end frame
loop."""
from tracking_sdf_tpu_torch.pipeline.trajectory import (
    Trajectory,
    TrajectoryWriter,
    align_umeyama,
    associate,
    ate_rmse,
    read_trajectory,
    rpe_rmse,
)
from tracking_sdf_tpu_torch.pipeline.realtime import (
    MultihostRealtimePacer,
    RealtimePacer,
)
from tracking_sdf_tpu_torch.pipeline.runner import (
    REFERENCE_INITIAL_POSE,
    FrameStats,
    Reconstruction,
)

__all__ = [
    "Trajectory",
    "TrajectoryWriter",
    "read_trajectory",
    "associate",
    "align_umeyama",
    "ate_rmse",
    "rpe_rmse",
    "MultihostRealtimePacer",
    "RealtimePacer",
    "Reconstruction",
    "FrameStats",
    "REFERENCE_INITIAL_POSE",
]
