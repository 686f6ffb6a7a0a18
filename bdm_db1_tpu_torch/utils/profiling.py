"""Tracing and profiling utilities (counterpart of
bdm_db1_tpu/utils/profiling.py): ``torch.profiler`` traces (Chrome/Perfetto
JSON, viewable in TensorBoard's profiler plugin too), named regions, a step
timer with tokens/sec accounting, and the card's memory statistics.

The reference's only observability is DeepSpeed's ``wall_clock_breakdown``
(reference: scripts/evaluate/evaluate_rl_1.2B.sh:35-40).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, *, host_profile: bool = False):
    """Capture a trace of the block, ``with profile_trace("traces"):
    step()``, into ``<log_dir>/trace.json``: the CPU ops always, the card's
    kernels when CUDA is up; ``host_profile`` adds shapes and Python
    stacks. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, record_shapes=host_profile,
                 with_stack=host_profile) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in the trace timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Rolling step-time / throughput meter (wall_clock_breakdown analogue).
    A step's time is host time between ticks: tick after a device sync (or
    a host read) to count the device's work."""

    def __init__(self, tokens_per_step: Optional[int] = None,
                 window: int = 50):
        self.tokens_per_step = tokens_per_step
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def steps_per_sec(self) -> float:
        t = self.mean_step_time
        return 1.0 / t if t else 0.0

    @property
    def tokens_per_sec(self) -> float:
        if not self.tokens_per_step:
            return 0.0
        return self.tokens_per_step * self.steps_per_sec

    def summary(self) -> Dict[str, float]:
        return {
            "step_time_ms": self.mean_step_time * 1e3,
            "steps_per_sec": self.steps_per_sec,
            "tokens_per_sec": self.tokens_per_sec,
        }


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in the JAX package's keys: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (the caching allocator's allocated bytes, now and
    at peak) and ``bytes_limit`` (the card's total memory). ``{}`` for a
    CPU device or where CUDA is not up."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(
            torch.cuda.get_device_properties(dev).total_memory),
    }
