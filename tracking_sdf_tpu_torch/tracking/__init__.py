"""Depth preprocessing and Gauss-Newton camera tracking."""
from tracking_sdf_tpu_torch.tracking.gauss_newton import (
    normal_equations,
    pixel_residuals_analytic,
    pixel_residuals_central,
    strided_points,
    track_frame,
)
from tracking_sdf_tpu_torch.tracking.preprocess import (
    bilateral_filter,
    estimate_normals,
    preprocess_frame,
)
