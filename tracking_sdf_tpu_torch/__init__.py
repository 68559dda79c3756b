"""tracking_sdf_tpu_torch — the PyTorch/CUDA port of tracking_sdf_tpu.

The JAX package ``tracking_sdf_tpu`` is the reference; this package mirrors
its module layout (``core``, ``grid``, ``fusion``, ``tracking``, ``render``,
``parallel``, ``pipeline``, ``data``, ``utils``) and its import surface:
every name that a JAX package ``__init__`` exports resolves at the same path
here (``parallel``'s JAX sharding objects apart: the port's mesh holds
slabs). It imports ``torch``, never ``jax`` and nothing of the JAX package:
its configuration is its own ``config`` module, field for field equal to
the JAX package's (pinned by ``tests/test_torch_config.py``).

It runs every mode of the JAX package on the card: the presets' brick-major
frame loop per frame and chunked (CUDA-graph replays of one captured frame
step), the dense, flat bricked and ``packed`` layouts (``packed`` as float32
brick-major rows), rendering and meshing, and multi-device runs over a
torch.distributed group, with its hand-written CUDA kernels
(``tracking/gn_reduce.py``, ``fusion/brick_merge.py``,
``fusion/brick_fuse.py``; sources in ``csrc/``). Entry points run on the GPU
unless the caller passes ``device="cpu"`` (or ``--cpu``).
"""
import torch

# Full float32 products on the card. TF32 keeps about three decimal digits;
# the JAX package runs its pose algebra and normal equations at
# Precision.HIGHEST (tracking_sdf_tpu/tracking/gauss_newton.py).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from tracking_sdf_tpu_torch import config as config  # noqa: E402
from tracking_sdf_tpu_torch.config import (  # noqa: E402
    FusionConfig,
    GridParams,
    PipelineConfig,
    RaycastConfig,
    TrackingConfig,
    preset,
)

# The subpackages load on first touch, as in the JAX package.
_SUBMODULES = (
    "core", "grid", "fusion", "tracking", "render",
    "parallel", "pipeline", "data", "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"tracking_sdf_tpu_torch.{name}")
    raise AttributeError(f"module 'tracking_sdf_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_SUBMODULES))
