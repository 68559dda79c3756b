"""Lie-group pose algebra and the pinhole camera."""
from tracking_sdf_tpu_torch.core.camera import (
    PinholeCamera,
    ros_default_camera,
    tum_fr1_camera,
)
from tracking_sdf_tpu_torch.core.lie import (
    Pose,
    pose_apply,
    pose_compose,
    pose_identity,
    pose_inverse,
    se3_exp,
    se3_log,
    so3_exp,
    so3_hat,
    so3_log,
)
