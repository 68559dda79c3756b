"""Timing and tracing helpers, and the --debug-nans switch."""
from tracking_sdf_tpu_torch.utils.profiling import Timer, device_timer, trace

__all__ = ["Timer", "device_timer", "trace"]
