"""Profiling and tracing — the counterpart of the reference's NVTX
ranges (`tests/test_llama.py:5,180-182` `nvtx.range_push("llama_decode")`)
and tokens/s wall-clock harness (`chat/chat.py:30-50`), as reusable
primitives:

- ``trace(name)`` / ``trace_context(name)``: `jax.profiler` trace
  annotations (named ranges in the profiler timeline).
- ``LatencyStats``: running latency aggregator for serving loops.
- ``card_name_and_power``: the GPU's name and power limit, which every
  device number is reported beside.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import List

import jax
import numpy as np


def trace(name: str):
    """Decorator: annotate a function with a named profiler trace range."""
    def deco(fn):
        return jax.named_scope(name)(fn)
    return deco


@contextlib.contextmanager
def trace_context(name: str):
    """Named range in the device profile (use under `jax.profiler.trace`)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@dataclasses.dataclass
class LatencyStats:
    """Streaming latency aggregator (serving loops, decode steps)."""

    samples: List[float] = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    def percentile_s(self, p: float) -> float:
        return float(np.percentile(self.samples, p)) if self.samples else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": self.mean_s * 1e3,
            "p50_ms": self.percentile_s(50) * 1e3,
            "p99_ms": self.percentile_s(99) * 1e3,
        }


def card_name_and_power() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them,
    read by a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: no output"
