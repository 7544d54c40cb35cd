"""Optimizer substrate: AdamW (configurable state dtype), LR schedules
(cosine, WSD), gradient clipping and compression."""

from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.compress import (ErrorFeedbackCompressor,
                                        dequantize_int8, quantize_int8)
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule

__all__ = ["AdamW", "OptState", "cosine_schedule", "wsd_schedule",
           "quantize_int8", "dequantize_int8", "ErrorFeedbackCompressor"]
