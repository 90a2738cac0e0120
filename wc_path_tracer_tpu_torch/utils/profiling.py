"""Tracing / profiling helpers (port of the JAX package's
utils/profiling.py).

The reference's tracing is Vulkan debug-utils labels surfacing in
RenderDoc, plus a live FPS panel.  Here:

- ``stage(name, device)``: a named scope that shows up in
  ``torch.profiler`` traces (``record_function``) and, when the work runs
  on a CUDA device, as an NVTX range;
- ``StepTimer``: rolling frame-time stats for utils.metrics records;
- ``profile_trace(path)``: a ``torch.profiler`` session written as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def stage(name: str, device=None):
    """Named scope for a pipeline stage.  ``device``: where the stage's
    tensors live; a CUDA device adds an NVTX range.

    Usage:
        with profiling.stage("render", scene.device):
            image = ...
    """
    cuda = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if cuda:
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


class StepTimer:
    """Rolling frame-time stats: the headless analog of the reference's FPS
    min/max/avg panel (src/editor.jai:322-353)."""

    def __init__(self, window: int = 64):
        self.window = window
        self.times: list = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def stats(self) -> dict:
        if not self.times:
            return dict(frames=0)
        return dict(
            frames=len(self.times),
            last_ms=self.times[-1] * 1e3,
            avg_ms=sum(self.times) / len(self.times) * 1e3,
            min_ms=min(self.times) * 1e3,
            max_ms=max(self.times) * 1e3,
        )


@contextlib.contextmanager
def profile_trace(path: str, device=None):
    """Profile the block (host activity, and the device's kernels when
    ``device`` is a CUDA device) and write a Chrome trace to ``path``.
    Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
