"""The fused shading kernel T1 (kernels/shade.py) as the transport engages
it, on the CPU.

The kernel runs only on the card, where tests/test_torch_gpu.py holds it
against ``golden._bounce`` bit for bit.  Here ``shade.on_card`` is patched
to say that the lanes lie on the card, and the kernel's entry is a stub
that records each call and answers with ``_bounce``'s shading of the same
lanes and hit record; every case renders 16 x 16 frames and holds the image
against the plain path's.
"""

import dataclasses
import re

import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import build, launches, shade
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.models.procedural import bunny_like_scene
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
from wc_path_tracer_tpu_torch.utils import profiling

CFG = RenderConfig(width=16, height=16, samples=1, max_bounces=2,
                   use_rr=True, rr_start_bounce=1)
FRAME = 3


class StubKernel:
    """Stands in for ``shade.shade_segment_kernel``: records each call's
    lanes and flags, and shades with ``_bounce`` (its counters kept apart,
    so the caller's are the fused path's own)."""

    def __init__(self, scene, cfg):
        self.scene, self.cfg, self.calls = scene, cfg, []

    def __call__(self, o, d, total, trans, seed, alive, rec, materials,
                 sky_gradient, rr):
        self.calls.append(dict(lanes=d.shape[0], rr=rr,
                               sky_gradient=sky_gradient))
        table, mtype = materials
        assert torch.equal(mtype, self.scene.materials.mtype)
        assert table.shape == (mtype.shape[0], 14) and table.is_contiguous()
        cfg = self.cfg.replace(use_rr=rr, rr_start_bounce=0,
                               sky="gradient" if sky_gradient else "black")
        s = golden.PathState(o=o, d=d, total=total, trans=trans, seed=seed,
                             alive=alive, pdf_prev=torch.zeros_like(d[:, 0]))
        with profiling.counting():
            out = golden._bounce(self.scene, cfg, lambda *a, **k: rec, s)
        return out.o, out.d, out.total, out.trans, out.seed, out.alive


def _cornell():
    return builtin.cornell_box_scene(device="cpu")


def _with_grad(field):
    """A Cornell box whose materials' ``field`` requires grad."""
    def make():
        scene, cam = _cornell()
        mats = scene.materials
        leaf = getattr(mats, field).clone().requires_grad_(True)
        return dataclasses.replace(scene, materials=dataclasses.replace(
            mats, **{field: leaf})), cam
    return make


# case -> (scene, config changes, grad mode, lanes "on the card", T1 takes
# the segments)
CASES = {
    "no-grad": (_cornell, {}, False, True, True),
    "grad-mode-nothing-requires-grad": (_cornell, {}, True, True, False),
    "grad-param": (_with_grad("albedo"), {}, True, True, False),
    "no-grad-param": (_with_grad("roughness"), {}, False, True, True),
    "use-nee": (_cornell, {"use_nee": True}, False, True, False),
    "cpu": (_cornell, {}, False, False, False),
    "compact": (_cornell, {"compact": True, "compact_blocks": 8}, False,
                True, True),
    "black-sky-no-rr": (_cornell, {"sky": "black", "use_rr": False}, False,
                        True, True),
    "sweep": (lambda: bunny_like_scene(2, device="cpu"), {}, False, True,
              True),
    "edge-grads": (_cornell, {"edge_grads": True, "use_nee": False}, False,
                   True, False),
}


def _frame(scene, mats, cfg, grad):
    fn = dispatch.get_intersect_fn("auto", scene, cfg)
    with torch.set_grad_enabled(grad):
        return golden.render_frame(scene, mats, cfg, FRAME, fn)


@pytest.mark.parametrize("case", list(CASES))
def test_engagement(case, monkeypatch):
    """T1 takes every segment of a trace where grad mode is off, NEE is off
    and the lanes lie on the card; elsewhere ``_bounce`` runs.  Either way
    the image is the plain path's, bit for bit."""
    make, changes, grad, card, fused = CASES[case]
    scene, cam = make()
    mats = camera_matrices(cam, 1.0)
    cfg = CFG.replace(**changes)
    want = _frame(scene, mats, cfg, grad)
    stub = StubKernel(scene, cfg)
    monkeypatch.setattr(shade, "shade_segment_kernel", stub)
    monkeypatch.setattr(shade, "on_card", lambda t: card)
    got = _frame(scene, mats, cfg, grad)
    assert torch.equal(got.detach(), want.detach())
    assert got.requires_grad == want.requires_grad
    if not fused:
        assert stub.calls == []
        return
    segments = cfg.max_bounces + 1
    if cfg.compact:
        assert 1 < len(stub.calls) <= segments
        assert stub.calls[-1]["lanes"] < CFG.width * CFG.height
    else:
        assert [c["lanes"] for c in stub.calls] == \
            [CFG.width * CFG.height] * segments
    assert [c["rr"] for c in stub.calls] == \
        [cfg.use_rr and b >= cfg.rr_start_bounce
         for b in range(len(stub.calls))]
    assert {c["sky_gradient"] for c in stub.calls} == {cfg.sky != "black"}


def test_renderer_and_alive_per_bounce_take_the_kernel(monkeypatch):
    """``Renderer.step`` (no grad) and ``alive_per_bounce`` shade through
    T1, with the plain path's image and live lanes."""
    scene, cam = _cornell()
    mats = camera_matrices(cam, 1.0)
    plain = Renderer(scene, cam, CFG, device="cpu")
    plain.step(2)
    alive = golden.alive_per_bounce(scene, mats, CFG, FRAME)
    stub = StubKernel(scene, CFG)
    monkeypatch.setattr(shade, "shade_segment_kernel", stub)
    monkeypatch.setattr(shade, "on_card", lambda t: True)
    r = Renderer(scene, cam, CFG, device="cpu")
    r.step(2)
    assert torch.equal(r.image, plain.image)
    assert len(stub.calls) == 2 * (CFG.max_bounces + 1)
    assert torch.equal(golden.alive_per_bounce(scene, mats, CFG, FRAME),
                       alive)
    assert len(stub.calls) == 3 * (CFG.max_bounces + 1)


@pytest.mark.parametrize("make", [_cornell,
                                  lambda: builtin.full_bsdf_scene("cpu")],
                         ids=["cornell", "full-bsdf"])
def test_packed_material_table(make):
    """``pack_materials``' columns are the materials' fields in
    ``COLUMNS``' order, the type ids beside them, and ``_gather_material``
    reads each field back from its columns."""
    materials = make()[0].materials
    table, mtype = shade.pack_materials(materials)
    rows = torch.arange(materials.capacity)
    m = golden._gather_material(materials, rows)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert mtype.dtype == torch.int32 and torch.equal(mtype, m["mtype"])
    col = 0
    for name, width in shade.COLUMNS:
        field = getattr(materials, name).reshape(-1, width)
        assert torch.equal(table[:, col:col + width], field), name
        assert torch.equal(m[name].reshape(-1, width), field), name
        col += width
    assert col == table.shape[1] == 14


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_query_counters_equal_the_plain_paths(compact, monkeypatch):
    """Where T1 shades, the closest-hit queries (and the compaction's
    partitions) are counted as on the plain path: ``intersect.lanes`` and
    ``intersect.alive`` are the same, and T1 took one call per query, of
    the lanes ``shade.lanes`` counts, which the plain path never counts."""
    scene, cam = _cornell()
    mats = camera_matrices(cam, 1.0)
    cfg = CFG.replace(compact=compact, compact_blocks=8)
    with torch.no_grad(), profiling.counting() as plain:
        golden.render_frame(scene, mats, cfg, FRAME)
    stub = StubKernel(scene, cfg)
    monkeypatch.setattr(shade, "shade_segment_kernel", stub)
    monkeypatch.setattr(shade, "on_card", lambda t: True)
    with torch.no_grad(), profiling.counting() as fused:
        golden.render_frame(scene, mats, cfg, FRAME)
    shaded = fused.pop("shade.lanes")
    assert fused == plain
    assert set(plain) == {"intersect.lanes", "intersect.alive"} | (
        {"compact.alive", "compact.kept"} if compact else set())
    assert sum(c["lanes"] for c in stub.calls) == shaded \
        == fused["intersect.lanes"]


def _c_parameters(src, fn):
    """The parameter count of the C function ``fn`` defined in ``src``."""
    m = re.search(r'extern "C"[^(;]*\b' + fn + r"\(([^)]*)\)", src)
    assert m, fn
    return len(m.group(1).split(","))


@pytest.mark.parametrize("tag", sorted(launches.KERNELS, key=lambda t:
                                       launches.KERNELS[t].library),
                         ids=lambda t: launches.KERNELS[t].library)
def test_kernel_sources_match_their_signatures(tag):
    """Every CUDA kernel of ``launches.KERNELS`` (T1's among them) has its
    source in ``csrc/``, defining its entry with as many parameters as its
    ctypes signature passes, and the one-parameter
    ``wc_cuda_error_string`` that ``build.load`` binds."""
    k = launches.KERNELS[tag]
    src = build.source(k.library).read_text()
    assert _c_parameters(src, k.entry) == len(k.argtypes), k.entry
    assert _c_parameters(src, "wc_cuda_error_string") == 1


def test_kernel_entry_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only: the transport shades
    CPU lanes with ``_bounce``."""
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        shade.shade_segment_kernel(
            z, z, z, z, torch.zeros(4, dtype=torch.int64),
            torch.ones(4, dtype=torch.bool), None, None, True, False)
