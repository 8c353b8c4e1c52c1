"""Tracing and step timing.

Counterpart of ``graph_wavenet_tpu/train/profiling.py``:

- :func:`trace`: a ``torch.profiler`` context over host and CUDA activity
  that writes a Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) into a directory; ``gwt-torch-train --profile
  DIR`` wraps a whole run in it;
- :class:`StepTimer`: wall-clock step timing that synchronizes the step
  output's CUDA device before it reads the clock, so an interval covers
  the device work and not only the launches;
- :func:`log_compile_time`: the first call's time against a steady one;
  on the card the first call pays the kernels' loading and any CUDA graph
  capture.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside (host and, where a card exists, CUDA
    activity) and write ``logdir/trace.json`` on exit; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _sync(leaf) -> None:
    """Wait for the CUDA device of the first tensor in ``leaf`` (a tensor,
    or a dict, list or tuple holding tensors)."""
    if torch.is_tensor(leaf):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        return
    if isinstance(leaf, dict):
        leaf = list(leaf.values())
    if isinstance(leaf, (list, tuple)):
        for v in leaf:
            if torch.is_tensor(v) or isinstance(v, (dict, list, tuple)):
                return _sync(v)


@dataclass
class StepTimer:
    """Call ``start()`` once, then ``tick(leaf)`` after each step; ``leaf``
    is any output of the step, whose device is synchronized first."""

    times: list = field(default_factory=list)
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self, leaf=None):
        if leaf is not None:
            _sync(leaf)
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
        self._t0 = now

    def summary(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps_per_s": float(1.0 / t.mean()),
        }


def log_compile_time(fn, *args, **kwargs) -> dict:
    """Wall times of a first and a second call of ``fn``, each up to its
    output's device sync, and their difference."""
    t0 = time.perf_counter()
    _sync(fn(*args, **kwargs))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _sync(fn(*args, **kwargs))
    steady = time.perf_counter() - t0
    return {"first_call_s": first, "steady_call_s": steady,
            "compile_overhead_s": first - steady}
