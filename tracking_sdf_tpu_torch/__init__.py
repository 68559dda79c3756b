"""tracking_sdf_tpu_torch — the PyTorch/CUDA port of tracking_sdf_tpu.

The JAX package ``tracking_sdf_tpu`` is the reference; this package mirrors
its module layout (``core``, ``grid``, ``tracking``, ``fusion``,
``pipeline``, ``data``) so each function has a counterpart of the same name.
It imports ``torch``, never ``jax`` and nothing of the JAX package: its
configuration is its own ``config`` module, field for field equal to the JAX
package's (pinned by ``tests/test_torch_config.py``).

Covered so far: the single-device brick-major frame loop that the ``tum256``
and ``tum512`` presets run, per frame and chunked (``process_chunk``,
``run(chunk=N)``: CUDA-graph replays of one captured frame step), and the
flat bricked loop (``FusionConfig(mode="bricked", brick_merge="pallas")``),
with their hand-written CUDA kernels (``tracking/gn_reduce.py``,
``fusion/brick_merge.py``, ``fusion/brick_fuse.py``; sources in ``csrc/``).
Every constructor and entry point takes an explicit ``device``.
"""
import torch

# Full float32 products on the card. TF32 keeps about three decimal digits;
# the JAX package runs its pose algebra and normal equations at
# Precision.HIGHEST (tracking_sdf_tpu/tracking/gauss_newton.py).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
