"""The port's spans and counters (utils/profiling.py).

A span is a ``record_function`` range only while a profiler records, and
costs nothing else; a served frame opens exactly the spans of
``profiling.SPANS``, nested as it says; the counters count the lanes handed
to each closest-hit query and the live ones among them, inside
``counting()`` only; and neither changes a pixel.  16 x 16, 2 bounces,
1 spp: a 320-triangle mesh (above dispatch "auto"'s crossover, so the
cluster sweep answers through its plain twin) and the 32-triangle Cornell
box (brute force).
"""

import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.models.procedural import bunny_like_scene
from wc_path_tracer_tpu_torch.render import golden, sweep
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
from wc_path_tracer_tpu_torch.utils import profiling

PACKAGE = Path(__file__).resolve().parent.parent / "wc_path_tracer_tpu_torch"
CFG = RenderConfig(width=16, height=16, samples=1, max_bounces=2,
                   use_rr=True, rr_start_bounce=1)
SCENES = {"sweep": lambda: bunny_like_scene(2, device="cpu"),
          "brute": lambda: builtin.cornell_box_scene(device="cpu")}
PARENT = dict(profiling.SPANS)
SWEEP_SPANS = {n for n in PARENT if n.startswith("sweep.")}


def renderer(kind, **kw):
    scene, cam = SCENES[kind]()
    return Renderer(scene, cam, CFG.replace(**kw), device="cpu")


def served_frame(r):
    """One frame through the Renderer, then its output."""
    image = r.step(1).clone()
    r.output()
    return image


def span_tree(prof):
    """[(span, nearest enclosing span or None)] of a profile's host events,
    in the order they started."""
    out = []
    for e in prof.events():
        if e.name not in PARENT:
            continue
        up = e.cpu_parent
        while up is not None and up.name not in PARENT:
            up = up.cpu_parent
        out.append((e.time_range.start, e.name,
                    None if up is None else up.name))
    return [(name, up) for _, name, up in sorted(out)]


def test_stage_records_nothing_with_the_profiler_off(monkeypatch):
    """Without a profiler no span calls ``record_function``; outside
    ``counting()`` no counter keeps anything."""
    def spy(*args, **kw):
        raise AssertionError(f"record_function{args} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    served_frame(renderer("sweep"))
    served_frame(renderer("brute"))
    assert profiling.count("intersect.lanes", 5) is None
    with profiling.counting() as counts:
        pass
    assert counts == {}


@pytest.mark.parametrize("kind", ["sweep", "brute"])
def test_frame_opens_the_spans_nested(kind):
    """Under torch.profiler a served frame opens the ``SPANS`` names and no
    other, each inside its parent: ``bounce`` and ``intersect`` once a
    segment, the sweep's spans once a query on the mesh and never on the
    box."""
    r = renderer(kind)
    served_frame(r)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served_frame(r)
    tree = span_tree(prof)
    assert all(up == PARENT[name] for name, up in tree), tree
    names = [name for name, _ in tree]
    segments = CFG.max_bounces + 1
    assert names.count("render_step") == names.count("post") == 1
    assert names.count("bounce") == names.count("intersect") == segments
    if kind == "sweep":
        assert set(names) == set(PARENT)
        assert names.count("sweep.tables") == 1
        for span in ("sweep.cull", "sweep.kernel", "sweep.reshade"):
            assert names.count(span) == segments, span
        # the dynamic sort: the regrouping, then its inverse
        assert names.count("sweep.sort") == 2 * segments
    else:
        assert set(names) == set(PARENT) - SWEEP_SPANS


def test_every_stage_in_the_package_is_a_listed_span():
    """Each ``stage("...")`` of the package names a span of ``SPANS``, and
    each span of ``SPANS`` is opened somewhere."""
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        opened |= set(re.findall(r'\bstage\(\s*"([^"]+)"',
                                 path.read_text()))
    assert opened == set(PARENT)
    assert len(profiling.SPANS) == len(PARENT)


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_counters_count_queried_and_live_lanes(compact):
    """``intersect.lanes`` is W·H·spp·(bounces+1) on the plain path and
    the compacted widths under ``compact``; ``intersect.alive`` is the
    frame's live lanes per bounce, ``golden.alive_per_bounce`` summed."""
    scene, cam = SCENES["sweep"]()
    mats = camera_matrices(cam, 1.0)
    cfg = CFG.replace(compact=compact, compact_blocks=8)
    fn = sweep.make_intersect_fn(scene, cfg)
    alive = int(golden.alive_per_bounce(scene, mats, CFG, 3, fn).sum())
    with profiling.counting() as counts:
        golden.render_frame(scene, mats, cfg, 3, fn)
    lanes = CFG.width * CFG.height * CFG.samples * (CFG.max_bounces + 1)
    assert set(counts) == set(profiling.COUNTERS)
    assert all(type(v) is int for v in counts.values())
    assert counts["intersect.alive"] == alive < lanes
    if compact:
        assert alive <= counts["intersect.lanes"] < lanes
    else:
        assert counts["intersect.lanes"] == lanes


@pytest.mark.parametrize("kind", ["sweep", "brute"])
def test_tracing_leaves_the_image_bit_for_bit(kind):
    """A frame rendered under the profiler and inside ``counting()`` is the
    frame rendered with both off."""
    plain = served_frame(renderer(kind))
    with profile(activities=[ProfilerActivity.CPU]), profiling.counting():
        traced = served_frame(renderer(kind))
    assert torch.equal(plain, traced)


def test_span_probe_charges_device_time_and_gaps_to_spans():
    """tools/torch_span_probe.py's arithmetic on made-up events (ns): two
    kernels launched inside ``intersect`` and one in ``render_step`` alone;
    a gap while the host is in ``bounce`` outside ``intersect``, one
    inside it."""
    from tools import torch_span_probe as probe

    host = [(0, 2000, "render_step"), (40, 1500, "bounce"),
            (80, 320, "intersect")]
    # (name, device start, duration, host launch time)
    ops = [("k1", 100, 50, 85), ("k2", 200, 100, 300),
           ("k3", 1000, 100, 1600), ("copy", 1200, 10, None)]
    ms = 1e-6
    assert probe.device_ms(ops, host) == pytest.approx(
        {"render_step": 250 * ms, "bounce": 150 * ms, "intersect": 150 * ms})
    assert probe.self_ms(ops, host) == pytest.approx(
        {"intersect": 150 * ms, "render_step": 100 * ms,
         probe.NO_SPAN: 10 * ms})
    # gaps: 150..200 (mid 175, intersect), 300..1000 (mid 650, bounce),
    # 1100..1200 (mid 1150, bounce)
    assert probe.idle_ms(ops, host) == pytest.approx(
        {"intersect": 50 * ms, "bounce": 800 * ms})
    assert probe.idle_ms([], host) == {}
