"""The span pass's arithmetic (perfbench/trace.py) on made-up events (ns),
the order of its profiled and counted frames, and the per-layer readers of
its spans and counters on hand-built views: no profiler, no card."""

import contextlib
import heapq
import random

import pytest

from perfbench import harness, trace

MS = 1e-6
# render_step > bounce > intersect, nested; nee beside intersect under
# bounce; times in ns
HOST = [(0, 2000, "render_step"), (40, 1500, "bounce"),
        (80, 320, "intersect"), (400, 900, "nee")]
# (name, device start, duration, host launch time)
OPS = [("k1", 100, 50, 85), ("k2", 200, 100, 300), ("k3", 1000, 100, 1600),
       ("copy", 1200, 10, None), ("k4", 1300, 20, 500)]


def test_an_operation_counts_for_every_span_around_its_launch():
    """k1 and k2 launch inside intersect, so inside bounce and render_step
    too; k4 inside nee; k3 in render_step alone; the copy names no
    launch."""
    assert trace.device_ms(OPS, HOST) == pytest.approx(
        {"render_step": 270 * MS, "bounce": 170 * MS, "intersect": 150 * MS,
         "nee": 20 * MS})


def test_self_time_goes_to_the_innermost_span_alone():
    assert trace.self_ms(OPS, HOST) == pytest.approx(
        {"intersect": 150 * MS, "render_step": 100 * MS, "nee": 20 * MS,
         trace.NO_SPAN: 10 * MS})


def test_a_gap_goes_to_the_innermost_span_at_its_middle():
    """Gaps 150..200 (middle 175: intersect), 300..1000 (650: nee),
    1100..1200 (1150: bounce), 1210..1300 (1255: bounce); a gap whose
    middle lies outside every span goes to NO_SPAN."""
    assert trace.idle_ms(OPS, HOST) == pytest.approx(
        {"intersect": 50 * MS, "nee": 700 * MS, "bounce": 190 * MS})
    late = OPS + [("k5", 3000, 10, 2500)]      # gap 1320..3000, middle 2160
    assert trace.idle_ms(late, HOST)[trace.NO_SPAN] == pytest.approx(
        1680 * MS)
    assert trace.idle_ms([], HOST) == {}


def test_of_two_spans_opened_at_once_the_shorter_is_innermost():
    host = [(0, 100, "bounce"), (0, 50, "intersect")]
    assert trace.innermost(host, [10, 60, 200]) == [
        "intersect", "bounce", trace.NO_SPAN]


def test_within_splits_one_span_by_its_children():
    """The operations launched inside ``shadow`` by innermost span, and the
    gaps whose middle lies inside it; the closest hit's ``intersect`` keeps
    its own."""
    host = [(0, 3000, "bounce"), (100, 900, "intersect"),
            (200, 500, "sweep.kernel"), (1000, 2500, "nee"),
            (1200, 2200, "shadow"), (1300, 1600, "sweep.kernel")]
    ops = [("b1", 300, 100, 250), ("b1", 1700, 200, 1400),
           ("glue", 2000, 50, 1900), ("t", 2600, 10, 2550)]
    shadow = trace.within(ops, host, "shadow")
    assert shadow["device_ms"] == pytest.approx(
        {"sweep.kernel": 200 * MS, "shadow": 50 * MS})
    assert shadow["idle_ms"] == pytest.approx({"shadow": 100 * MS})
    closest = trace.within(ops, host, "intersect")
    assert closest["device_ms"] == pytest.approx({"sweep.kernel": 100 * MS})
    assert closest["idle_ms"] == {}


def test_the_readings_are_per_frame():
    """Two frames: the same events shifted by a frame's length read, per
    frame, as one; the counters' totals are divided too."""
    shift = 10_000
    host = HOST + [(s + shift, e + shift, n) for s, e, n in HOST]
    ops = OPS + [(n, s + shift, d, None if t is None else t + shift)
                 for n, s, d, t in OPS]
    one = trace.span_split(OPS, HOST, {"intersect.lanes": 64}, 1)
    two = trace.span_split(ops, host, {"intersect.lanes": 128}, 2)
    assert two["counters"] == {"intersect.lanes": 64}
    for key in ("device", "self"):
        assert two[key] == pytest.approx(one[key])
    # the gap between the frames (1320 .. 10100) falls outside every span
    between = (shift + 100 - 1320) * MS / 2
    assert two["idle"] == pytest.approx(
        dict(one["idle"], **{trace.NO_SPAN: between}))


def old_gaps_by_host(ops, host, top=10):
    """idle_gaps' reading of a profile as it was written before it shared
    innermost(): the breakdown's oracle."""
    host = sorted(host)
    spans = trace.merged((s, s + d) for _, s, d in ops)
    gaps = sorted(((end + nxt) / 2, (nxt - end) / 1e9)
                  for (_, end), (nxt, _) in zip(spans, spans[1:]))
    by_name: dict = {}
    active: list = []
    i = 0
    for mid, seconds in gaps:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host operation)"
        by_name[name] = by_name.get(name, 0.0) + seconds
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


@pytest.mark.parametrize("seed", range(4))
def test_the_breakdowns_idle_gaps_read_as_before(seed):
    """Random operations, and host operations with equal starts, equal
    spans under two names and gaps outside every one: the same list, to
    the last digit."""
    rng = random.Random(seed)
    ops = [(f"k{i}", rng.randrange(0, 20_000, 7), rng.randrange(1, 200))
           for i in range(60)]
    host = []
    for i in range(200):
        s = rng.randrange(0, 20_000, 5)
        e = s + rng.randrange(1, 800)
        host.append((s, e, f"op{rng.randrange(12)}"))
        if i % 3 == 0:
            host.append((s, e, f"op{rng.randrange(12)}"))
        if i % 4 == 0:
            host.append((s, s + rng.randrange(1, 200),
                         f"op{rng.randrange(12)}"))
    want = old_gaps_by_host(ops, host)
    assert want and trace.gaps_by_host(ops, host) == want


def test_the_span_pass_counts_outside_its_profiled_frames(monkeypatch):
    """One profiled frame dropped, ``frames`` profiled ones uncounted, then
    as many counted ones unprofiled; the counters read per frame."""
    state = {"profiled": False, "counted": False}
    seen = []

    @contextlib.contextmanager
    def profiler(cpu):
        assert cpu
        state["profiled"] = True
        yield None
        state["profiled"] = False

    @contextlib.contextmanager
    def counting():
        state["counted"] = True
        out = {}
        yield out
        state["counted"] = False
        out["intersect.lanes"] = 3 * len(seen)

    def run_units(n):
        seen.extend([(state["profiled"], state["counted"])] * n)

    monkeypatch.setattr(trace, "_profiler", profiler)
    monkeypatch.setattr(trace.program, "counting", counting)
    monkeypatch.setattr(trace, "kineto", lambda prof, names: (OPS, HOST))
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda device: None)
    split = trace.span_pass(run_units, "cuda", 5)
    assert seen == [(True, False)] * 6 + [(False, True)] * 5
    assert split["counters"] == {"intersect.lanes": 3 * 11 / 5}
    assert split["self"] == pytest.approx(
        {k: v / 5 for k, v in trace.self_ms(OPS, HOST).items()})


def test_the_span_pass_holds_one_cycle_of_the_traffic():
    """Its profiled and its counted frames each hold one edit, the camera
    steps and the still frames, once each."""
    bench = harness.spec()
    for cell in bench["workloads"]:
        _, _, tr, _ = harness.cell_parts(bench, cell["name"])
        if tr["kind"] == "serve":
            assert tr["span_frames"] == tr["cycle"], cell["name"]


def view(span_ms=None, counters=None):
    return harness.MetricView(stretch=None, render={}, world=1,
                              scene_sizes={}, spans={}, span_ms=span_ms,
                              counters=counters)


SPAN_MS = {
    "device": {"intersect": 10.1, "shadow": 5.4, "bounce": 12.0},
    "self": {"sweep.sort": 1.68, "sweep.cull": 0.42, "sweep.reshade": 1.52,
             "compact": 0.62, "nee": 5.65, "nee.tables": 1.37},
    "idle": {"bounce": 15.12, "sweep.sort": 11.15, "sweep.cull": 1.60,
             "sweep.reshade": 13.77, "compact": 2.62, "nee": 32.82,
             "nee.tables": 13.98}}
COUNTERS = {"intersect.lanes": 1000, "intersect.alive": 425,
            "compact.kept": 400, "compact.alive": 144,
            "shadow.lanes": 1000, "nee.lanes": 563}
# metric -> (its value on SPAN_MS and COUNTERS, the counter of its
# denominator or None)
READERS = {
    "intersect_ms.serve": (10.1, None),
    "live_lane_share.serve": (42.5, "intersect.lanes"),
    "sweep_glue_ms.serve": (1.68 + 0.42 + 1.52, None),
    "compact_ms.serve": (0.62, None),
    "padding_share.serve": (64.0, "compact.kept"),
    "nee_ms.serve": (5.65 + 1.37, None),
    "shadow_ms.serve": (5.4, None),
    "nee_lane_share.serve": (56.3, "shadow.lanes"),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_its_spans_and_counters(name):
    want, _ = READERS[name]
    read = harness.metric_reader(name)
    assert read(view(SPAN_MS, COUNTERS)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_where_no_pass_ran(name):
    assert harness.metric_reader(name)(view()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_where_it_finds_nothing(name):
    """A zero denominator, or a pass in which none of the reader's spans
    opened."""
    _, denominator = READERS[name]
    read = harness.metric_reader(name)
    if denominator:
        assert read(view(SPAN_MS, dict(COUNTERS, **{denominator: 0}))) \
            is None
        assert read(view(SPAN_MS, {})) is None
    else:
        assert read(view({"device": {}, "self": {}, "idle": {}},
                         COUNTERS)) is None
