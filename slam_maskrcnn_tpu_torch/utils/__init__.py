"""Tracing and timing (utils/profiling.py)."""

from slam_maskrcnn_tpu_torch.utils.profiling import (StageTimer, log_tensor,
                                                     trace)

__all__ = ["StageTimer", "log_tensor", "trace"]
