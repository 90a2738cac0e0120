"""The port's spans and counters (utils/profiling.py).

A span is a ``record_function`` range only while a profiler records, and
costs nothing else; a served frame opens exactly the spans of
``profiling.SPANS``, nested as it says; the counters count the lanes handed
to each closest-hit query and the live ones among them, inside
``counting()`` only; and neither changes a pixel.  16 x 16, 2 bounces,
1 spp: a 320-triangle mesh (above dispatch "auto"'s crossover, so the
cluster sweep answers through its plain twin), the 32-triangle Cornell
box (brute force), the full-BSDF box under alive-lane compaction
(brute force; its partitions are the ``compact`` span and counters) and
the mesh in GGX under a lamp with NEE and MIS on (the light sample is the
``nee`` span, its shadow query through the sweep the ``shadow`` span).
"""

import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.models import procedural
from wc_path_tracer_tpu_torch.models.procedural import bunny_like_scene
from wc_path_tracer_tpu_torch.render import golden, sweep
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene import types
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
from wc_path_tracer_tpu_torch.utils import profiling

PACKAGE = Path(__file__).resolve().parent.parent / "wc_path_tracer_tpu_torch"
CFG = RenderConfig(width=16, height=16, samples=1, max_bounces=2,
                   use_rr=True, rr_start_bounce=1)


def lit_scene():
    """``bunny_like_scene(2)``'s mesh as a GGX conductor over a Lambertian
    ground sphere, lit by a small emissive sphere clear of both: under
    MIS both lobes sample the lamp."""
    b = types.SceneBuilder()
    body = b.add_material(types.MATERIAL_GGX, albedo=(0.65, 0.6, 0.5),
                          roughness=0.3, metallic=1.0)
    ground = b.add_material(types.MATERIAL_LAMBERTIAN, albedo=(0.6, 0.6, 0.6))
    lamp = b.add_material(types.MATERIAL_LAMBERTIAN, emission=(1.0, 1.0, 1.0),
                          emission_strength=20.0)
    v, idx = procedural.bumpy_sphere(2)
    v[:, 1] += 1.0
    b.add_mesh(v, idx, tri_material=body)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((-2.0, 3.0, 1.0), 0.5, lamp)
    return b.build("cpu"), bunny_like_scene(2, device="cpu")[1]


SCENES = {"sweep": lambda: bunny_like_scene(2, device="cpu"),
          "brute": lambda: builtin.cornell_box_scene(device="cpu"),
          "compact": lambda: builtin.full_bsdf_scene(device="cpu"),
          "nee": lit_scene}
# the full-BSDF box compacts from bounce rr_start_bounce + 1, in blocks of
# 256 / 8 lanes
COMPACT = dict(compact=True, compact_blocks=8, sky="black")
NEE = dict(use_nee=True, mis=True)
PARENT = {name: up if isinstance(up, tuple) else (up,)
          for name, up in profiling.SPANS}
SWEEP_SPANS = {n for n in PARENT if n.startswith("sweep.")}
NEE_SPANS = {"nee", "nee.tables", "shadow"}


def renderer(kind, **kw):
    scene, cam = SCENES[kind]()
    kw = {**{"compact": COMPACT, "nee": NEE}.get(kind, {}), **kw}
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


@pytest.mark.parametrize("kind", ["sweep", "brute", "compact", "nee"])
def test_frame_opens_the_spans_nested(kind):
    """Under torch.profiler a served frame opens the ``SPANS`` names and no
    other, each inside one of its parents: ``bounce`` and ``intersect`` once
    a segment, the sweep's spans once a query on the mesh and never on the
    boxes, ``compact`` once a compacted bounce and once for the restore,
    and only under compaction; under NEE and MIS ``nee`` and ``shadow``
    once a segment, ``nee.tables`` twice (the pick's table inside ``nee``,
    the emission weight's in ``bounce``), and the sweep's sort, cull and
    kernel under ``shadow`` for the shadow query."""
    r = renderer(kind)
    served_frame(r)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served_frame(r)
    tree = span_tree(prof)
    assert all(up in PARENT[name] for name, up in tree), tree
    names = [name for name, _ in tree]
    segments = CFG.max_bounces + 1
    assert names.count("render_step") == names.count("post") == 1
    assert names.count("bounce") == names.count("intersect") == segments
    if kind in ("sweep", "nee"):
        queries = 2 * segments if kind == "nee" else segments
        assert set(names) == set(PARENT) - {"compact"} - (
            NEE_SPANS if kind == "sweep" else set())
        assert names.count("sweep.tables") == 1
        assert names.count("sweep.reshade") == segments
        for span in ("sweep.cull", "sweep.kernel"):
            assert names.count(span) == queries, span
        # the dynamic sort: the regrouping, then its inverse
        assert names.count("sweep.sort") == 2 * queries
        under = [up for name, up in tree if name == "sweep.kernel"]
        assert under.count("intersect") == segments
        assert under.count("shadow") == queries - segments
    elif kind == "brute":
        assert set(names) == set(PARENT) - SWEEP_SPANS - {"compact"} \
            - NEE_SPANS
    else:
        assert set(names) == set(PARENT) - SWEEP_SPANS - NEE_SPANS
        compacted = segments - r.cfg.compact_from_resolved
        assert compacted > 0
        assert names.count("compact") == compacted + 1
    if kind == "nee":
        assert names.count("nee") == names.count("shadow") == segments
        tables = [up for name, up in tree if name == "nee.tables"]
        assert tables.count("nee") == tables.count("bounce") == segments


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
    assert set(counts) == {"intersect.lanes", "intersect.alive"} | (
        {"compact.alive", "compact.kept"} if compact else set())
    assert all(type(v) is int for v in counts.values())
    assert counts["intersect.alive"] == alive < lanes
    if compact:
        assert alive <= counts["intersect.lanes"] < lanes
    else:
        assert counts["intersect.lanes"] == lanes


def test_nee_counters_count_light_and_shadow_lanes(monkeypatch):
    """Under NEE and MIS, ``nee.lanes`` is the lanes whose lobe samples a
    light (the masks handed to ``golden.sample_direct_light``) and
    ``shadow.lanes`` the lanes handed to the shadow query (the sweep's
    ``occlusion_fn``), and the counters change no pixel."""
    scene, cam = lit_scene()
    mats = camera_matrices(cam, 1.0)
    cfg = CFG.replace(**NEE)
    masks, handed = [], []
    sample = golden.sample_direct_light

    def spy_sample(scene, rec, seed, mask, intersect_fn, cfg):
        masks.append(int(mask.sum()))
        return sample(scene, rec, seed, mask, intersect_fn, cfg)

    fn = sweep.make_intersect_fn(scene, cfg)
    occlusion = fn.occlusion_fn

    def spy_occlusion(scene, origin, direction, max_dist, cfg):
        handed.append(origin.shape[0])
        return occlusion(scene, origin, direction, max_dist, cfg)

    plain = golden.render_frame(scene, mats, cfg, 3, fn)
    monkeypatch.setattr(golden, "sample_direct_light", spy_sample)
    fn.occlusion_fn = spy_occlusion
    with profiling.counting() as counts:
        counted = golden.render_frame(scene, mats, cfg, 3, fn)
    segments = cfg.max_bounces + 1
    lanes = cfg.width * cfg.height * cfg.samples
    assert len(masks) == len(handed) == segments
    assert type(counts["nee.lanes"]) is type(counts["shadow.lanes"]) is int
    assert counts["nee.lanes"] == sum(masks)
    assert 0 < counts["nee.lanes"] < counts["intersect.alive"]
    assert counts["shadow.lanes"] == sum(handed) == segments * lanes
    assert torch.equal(plain, counted)


def _compaction_counts(device):
    """(counters of one compacted full-BSDF frame at 16 x 16, 5 segments,
    the plain path's live lanes entering each bounce, lanes a block, first
    compacted bounce)."""
    scene, cam = builtin.full_bsdf_scene(device=device)
    mats = camera_matrices(cam, 1.0)
    cfg = CFG.replace(max_bounces=4, **COMPACT)
    with torch.no_grad():
        alive = golden.alive_per_bounce(scene, mats, cfg, 3).tolist()
        with profiling.counting() as counts:
            golden.render_frame(scene, mats, cfg, 3)
    return counts, alive, cfg.num_rays // cfg.compact_blocks, \
        cfg.compact_from_resolved


def test_compaction_counts_live_and_kept_lanes():
    """On the full-BSDF box, ``compact.alive`` is the live lanes entering
    the compacted bounces (``golden.alive_per_bounce``), ``compact.kept``
    each bounce's live lanes rounded up to the block, and on the CPU no
    lane goes to the fused shading kernel."""
    counts, alive, block, first = _compaction_counts("cpu")
    later = alive[first:]
    assert 0 < later[0] < CFG.width * CFG.height
    assert counts["compact.alive"] == sum(later)
    assert counts["compact.kept"] == sum(-(-a // block) * block
                                         for a in later)
    assert counts["compact.alive"] < counts["compact.kept"]
    assert "shade.lanes" not in counts


@pytest.mark.gpu
def test_compaction_and_shade_counters_on_the_card():
    """Where T1 shades, every lane handed to a query is handed to T1, and
    the compaction's counts are the plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts, alive, block, first = _compaction_counts("cuda")
    assert counts["shade.lanes"] == counts["intersect.lanes"]
    assert counts["compact.alive"] == sum(alive[first:])
    assert counts["compact.kept"] == sum(-(-a // block) * block
                                         for a in alive[first:])


@pytest.mark.parametrize("kind", ["sweep", "brute", "compact", "nee"])
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


def test_span_probe_splits_each_query_by_its_own_spans():
    """``within``: the operations launched inside ``shadow`` by innermost
    span, and the gaps whose middle lies inside it; the closest hit's
    ``intersect`` keeps its own."""
    from tools import torch_span_probe as probe

    host = [(0, 3000, "bounce"), (100, 900, "intersect"),
            (200, 500, "sweep.kernel"), (1000, 2500, "nee"),
            (1200, 2200, "shadow"), (1300, 1600, "sweep.kernel")]
    ops = [("b1", 300, 100, 250), ("b1", 1700, 200, 1400),
           ("glue", 2000, 50, 1900), ("t", 2600, 10, 2550)]
    ms = 1e-6
    shadow = probe.within(ops, host, "shadow")
    assert shadow["device_ms"] == pytest.approx(
        {"sweep.kernel": 200 * ms, "shadow": 50 * ms})
    # gaps: 400..1700 (mid 1050, nee: outside shadow), 1900..2000 (mid
    # 1950, shadow), 2050..2600 (mid 2325, nee)
    assert shadow["idle_ms"] == pytest.approx({"shadow": 100 * ms})
    closest = probe.within(ops, host, "intersect")
    assert closest["device_ms"] == pytest.approx({"sweep.kernel": 100 * ms})
    assert closest["idle_ms"] == {}


def test_span_probe_rehearses_the_full_bsdf_cell():
    """tools/torch_span_probe.py on the CPU (16 x 16) for ``bsdf-serve``:
    the compaction's counters and padding share, and the live lanes of
    each of the cell's 9 segments; no device numbers on a CPU."""
    from tools import torch_span_probe as probe

    r = probe.serve_cell("bsdf-serve", torch.device("cpu"), 16)
    c = r["counters"]
    assert c["compact.kept"] > c["compact.alive"] > 0
    assert r["padding_share"] == 1.0 - c["compact.alive"] / c["compact.kept"]
    assert len(r["alive_per_bounce"]) == 9
    assert r["alive_per_bounce"][0] == 16 * 16
    assert r["compact_ms"] is None and r["shade_ms"] is None
