"""Tracing / profiling helpers (port of the JAX package's
utils/profiling.py).

The reference's tracing is Vulkan debug-utils labels surfacing in
RenderDoc, plus a live FPS panel.  Here:

- ``stage(name, args)``: a named span at a layer boundary of the program.
  While a profiler records (``torch.profiler.profile``, or
  ``torch.autograd.profiler.emit_nvtx()`` for Nsight, which turns every
  span into an NVTX range) it is a ``record_function`` range, on the
  profiler's own clock beside the CUDA activity; otherwise it records
  nothing.  ``SPANS`` names every span the program opens;
- ``count(name, value)`` / ``counting()``: per-name totals of lanes and
  other counts, kept only inside ``counting()`` (``COUNTERS`` names them);
- ``profile_trace(path)``: a ``torch.profiler`` session written as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# (span, its parent in a served frame, None at the top; a tuple where the
# span opens under either).  The sweep's sort, cull and kernel serve the
# closest-hit query (under ``intersect``) and NEE's shadow query (under
# ``shadow``); the silhouette query opens them outside any span.
_QUERIES = ("intersect", "shadow")
SPANS = (
    ("render_step", None),       # Renderer.step: one frame, accumulated
    ("post", None),              # Renderer.output: bloom .. uint8 on host
    ("sweep.tables", "render_step"),  # the sweep's tables, once a frame
    ("bounce", "render_step"),   # golden._bounce_segment: one segment
    ("intersect", "bounce"),     # its closest-hit query, any backend
    ("sweep.sort", _QUERIES),    # the ray regrouping and its inverse
    ("sweep.cull", _QUERIES),    # padding, cull, cluster order, packing
    ("sweep.kernel", _QUERIES),  # the block sweep: B1, B2 or a twin
    ("sweep.reshade", "intersect"),  # the winner's vertices, resolve_hit
    ("nee", "bounce"),           # golden._bounce's light sample, MIS weight
    ("nee.tables", ("nee", "bounce")),  # golden._light_tables: the pick's
    #                              table, and the MIS emission weight's
    ("shadow", "nee"),           # NEE's shadow query, any backend
    ("compact", "render_step"),  # golden.trace_rays_compact: a later
    #                              bounce's partition, and the final restore
)

# counted at each closest-hit query of golden._bounce_segment: the lanes
# handed to it (the compacted width under ``compact``) and the live ones;
# at each partition of golden.trace_rays_compact: the live lanes and the
# block-rounded prefix handed to the bounce; at each launch of the fused
# shading kernel T1 (golden._bounce_fused): the lanes handed to it; at each
# launch of the brute-force search H1 (golden.intersect_scene_brute): the
# lanes handed to it; at each call of the post kernels P1
# (kernels/post.py::post_frame_kernel): the pixels handed to them; at each
# NEE light sample of golden._bounce: the lanes that sample a light (summed
# on the device), and the lanes handed to the shadow query; at each launch
# of the sweep's cull kernel C1 (kernels/cluster.py::cluster_sweep): the
# lanes handed to it
COUNTERS = ("intersect.lanes", "intersect.alive", "compact.alive",
            "compact.kept", "shade.lanes", "brute.lanes", "post.pixels",
            "nee.lanes", "shadow.lanes", "cull.lanes")

_OFF = contextlib.nullcontext()
_totals = contextvars.ContextVar("profiling_totals", default=None)


def stage(name: str, args: str | None = None):
    """Span ``name`` (one of ``SPANS``) around a block; ``args`` is recorded
    with the range.  Costs one check of the profiler's state when nothing
    records.

    Usage:
        with profiling.stage("render_step", str(frame)):
            image = ...
    """
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name, args)


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` inside ``counting()``: a Python
    int, or a tensor whose elements are summed on its device (no host
    sync).  Outside ``counting()`` it records nothing."""
    totals = _totals.get()
    if totals is None:
        return
    if isinstance(value, torch.Tensor):
        value = value.sum()
    totals[name] = totals.get(name, 0) + value


@contextlib.contextmanager
def counting():
    """Keep the counters of the block.  Yields a dict that, once the block
    exits, holds ``{name: int}``: each total read once, at the exit."""
    totals: dict = {}
    out: dict = {}
    token = _totals.set(totals)
    try:
        yield out
    finally:
        _totals.reset(token)
    out.update({k: int(v) for k, v in totals.items()})


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
