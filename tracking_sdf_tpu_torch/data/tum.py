"""TUM RGB-D frames (counterpart of tracking_sdf_tpu.data.tum's TUMFrame).

``Reconstruction.run`` consumes any iterable of such frames. The dataset
reader and its PNG loaders are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TUMFrame:
    timestamp: float
    depth: np.ndarray  # (H, W) float32 meters, NaN holes
    rgb: Optional[np.ndarray]  # (H, W, 3) float32 in [0, 1] or None
    gt_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (t(3,), q(4,)) if available
