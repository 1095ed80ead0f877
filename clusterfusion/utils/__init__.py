"""Utilities: profiling/tracing and native checkpoint save/resume — the
auxiliary subsystems inventory of SURVEY.md §5 (the reference has NVTX
ranges + a tokens/s print and a load-only checkpoint path; both are
first-class here)."""

from clusterfusion.utils.profiling import (
    LatencyStats,
    trace,
    trace_context,
)
from clusterfusion.utils.ckpt import (
    load_native_checkpoint,
    save_checkpoint,
)

__all__ = [
    "LatencyStats",
    "trace",
    "trace_context",
    "save_checkpoint",
    "load_native_checkpoint",
]
