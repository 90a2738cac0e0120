"""The brute-force closest-hit search H1 (kernels/brute.py) as the query
engages it, on the CPU.

The kernel runs only on the card, where tests/test_torch_gpu.py holds it
against ``golden._brute_search`` bit for bit.  Here the plain twin, with
the gathers and ``resolve_hit`` after it, is held against the query as it
was written before the split (``_unsplit_brute``); and ``brute.on_card`` is
patched to say that the lanes lie on the card, with a stub for the
kernel's entry that answers with the plain twin from the tensors it is
handed.  Frames are 16 x 16, queries at most 4,096 lanes.
"""

import dataclasses
import types

import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import brute
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.models.procedural import bunny_like_scene
from wc_path_tracer_tpu_torch.ops import intersect as ix
from wc_path_tracer_tpu_torch.render import golden
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene.camera import (camera_matrices,
                                                   primary_ray_directions)
from wc_path_tracer_tpu_torch.utils import profiling

CFG = RenderConfig(width=16, height=16, samples=1, max_bounces=2,
                   sky="black")
HIT_FIELDS = ("t", "p", "normal", "hit", "front", "material")


def _unsplit_brute(scene, origin, direction, cfg):
    """``golden.intersect_scene_brute`` as one function, before its search
    became ``_brute_search``: the (R, S) and (R, T) sweeps and their
    first-min, then the gathers and ``resolve_hit``."""
    mesh = scene.mesh
    t_s, sph_center, sph_radius, sph_material = golden.sphere_closest(
        scene, origin, direction, cfg)
    a_all, b_all, c_all = golden.triangle_vertices(mesh)
    t_t, t_hit = ix.ray_triangle_sweep(origin.detach(), direction.detach(),
                                       a_all.detach(), b_all.detach(),
                                       c_all.detach())
    t_tri_all = torch.where(t_hit & golden._live_triangle_mask(scene), t_t,
                            golden.KINF)
    t_tri, idx = golden._first_min(t_tri_all)
    abc = golden.take_rows(torch.cat([a_all, b_all, c_all], 1), idx)
    return golden.resolve_hit(origin, direction, cfg, t_s, sph_center,
                              sph_radius, sph_material, t_tri,
                              t_tri < golden.KINF, abc[:, 0:3], abc[:, 3:6],
                              abc[:, 6:9], mesh.tri_material[idx])


def _duplicated_triangle(scene):
    """Every live triangle slot after the first twelve repeats one of them
    with another material: each tie in t goes to the lower slot."""
    mesh = scene.mesh
    tri = mesh.indices.view(-1, 3).clone()
    live = int((mesh.tri_draw >= 0).sum())
    tri[12:live] = tri[torch.arange(12, live) % 12]
    mat = mesh.tri_material.clone()
    mat[12:live] = (mat[12:live] + 1) % scene.materials.capacity
    return dataclasses.replace(scene, mesh=dataclasses.replace(
        mesh, indices=tri.reshape(-1), tri_material=mat))


def _dead_slots(scene):
    """Every third live triangle slot moved to padding (draw -1), and the
    last live sphere past the live count."""
    mesh, sph = scene.mesh, scene.spheres
    draw = mesh.tri_draw.clone()
    draw[0:int((draw >= 0).sum()):3] = -1
    return dataclasses.replace(
        scene, mesh=dataclasses.replace(mesh, tri_draw=draw),
        spheres=dataclasses.replace(sph, count=(sph.count - 1).clamp_min(0)))


def _rays(scene, cam, n, seed):
    """Primary rays of a 16 x 16 frame, then ``n`` rays from seeded points
    inside the box in seeded directions."""
    g = torch.Generator().manual_seed(seed)
    mats = camera_matrices(cam, 1.0)
    d0 = primary_ray_directions(mats, 16, 16).reshape(-1, 3)
    o0 = mats.position.expand(d0.shape[0], 3)
    o1 = torch.rand(n, 3, generator=g) * torch.tensor([556.0, 548.0, 559.0])
    d1 = ix.normalize(torch.randn(n, 3, generator=g))
    return torch.cat([o0, o1]), torch.cat([d0, d1])


def _away(scene, cam, n, seed):
    """Rays from far outside the box, pointing away from it: all miss."""
    g = torch.Generator().manual_seed(seed)
    d = ix.normalize(torch.rand(n, 3, generator=g) + 0.1)
    return torch.full((n, 3), 1e4) + 10.0 * d, d


# case -> (scene, its change, rays, config changes)
_cornell = builtin.cornell_box_scene
_bsdf = builtin.full_bsdf_scene
CASES = {
    "cornell": (_cornell, None, _rays, {}),
    "full-bsdf": (_bsdf, None, _rays, {}),    # near roots only (default)
    "full-bsdf-both-roots": (_bsdf, None, _rays,
                             {"sphere_near_root_only": False}),
    "duplicated-triangles": (_cornell, _duplicated_triangle, _rays, {}),
    "all-miss": (_bsdf, None, _away, {}),
    "dead-slots": (_bsdf, _dead_slots, _rays, {}),
}


def _case(name):
    make, change, rays, changes = CASES[name]
    scene, cam = make(device="cpu")
    if change is not None:
        scene = change(scene)
    o, d = rays(scene, cam, 2048, seed=len(name))
    return scene, o, d, CFG.replace(**changes)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_twin_equals_the_unsplit_query(case):
    """``_brute_search`` with the gathers and ``resolve_hit`` after it gives
    the HitRecord of the query as it was written before, bit for bit, and
    its slots are the first-min of the full sweeps."""
    scene, o, d, cfg = _case(case)
    want = _unsplit_brute(scene, o, d, cfg)
    got = golden.intersect_scene_brute(scene, o, d, cfg)
    for name in HIT_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    t_s, s_idx, t_tri, t_idx = golden._brute_search(
        scene, o, d, cfg, *golden.triangle_vertices(scene.mesh))
    assert t_s.dtype == t_tri.dtype == torch.float32
    assert s_idx.dtype == t_idx.dtype == torch.int64
    hit = want.hit
    if case == "all-miss":
        assert not bool(hit.any())
        assert bool((t_s == golden.KINF).all() & (t_tri == golden.KINF).all())
        assert int(s_idx.abs().sum() + t_idx.abs().sum()) == 0
    else:
        assert bool(hit.any()) and not bool(hit.all())
    if case == "duplicated-triangles":
        assert int(t_idx.max()) < 12


def _stub(calls):
    """Stands in for ``brute.brute_hit_kernel``: records each call's lanes
    and answers with ``_brute_search`` over the tensors it is handed."""

    def kernel(origin, direction, position, radius, sphere_count, a, b, c,
               tri_draw, draw_count, near_root_only):
        calls.append(direction.shape[0])
        scene = types.SimpleNamespace(
            spheres=types.SimpleNamespace(position=position, radius=radius,
                                          count=sphere_count,
                                          capacity=radius.shape[0]),
            mesh=types.SimpleNamespace(tri_draw=tri_draw,
                                       draw_count=draw_count))
        cfg = CFG.replace(sphere_near_root_only=near_root_only)
        return golden._brute_search(scene, origin, direction, cfg, a, b, c)

    return kernel


SERVE = {
    "cornell": (_cornell, CFG),
    "full-bsdf": (_bsdf, CFG.replace(max_bounces=5, use_rr=True,
                                     rr_start_bounce=1, compact=True,
                                     compact_blocks=4, compact_from=2)),
}


@pytest.mark.parametrize("name", list(SERVE))
def test_renderer_frames_take_the_kernel(name, monkeypatch):
    """Where the lanes lie on the card, each closest-hit query of a
    ``Renderer`` frame on a box (dispatch "auto": brute force) is one call
    of the kernel's entry, over the lanes the query is handed
    (``brute.lanes`` equals ``intersect.lanes``); the image is the plain
    path's, bit for bit."""
    make, cfg = SERVE[name]
    scene, cam = make(device="cpu")
    plain = Renderer(scene, cam, cfg, device="cpu")
    plain.step(1)
    with profiling.counting() as plain_counts:
        plain.step(1)
    calls = []
    monkeypatch.setattr(brute, "brute_hit_kernel", _stub(calls))
    monkeypatch.setattr(brute, "on_card", lambda t: True)
    r = Renderer(scene, cam, cfg, device="cpu")
    r.step(1)
    assert len(calls) == cfg.max_bounces + 1
    with profiling.counting() as counts:
        r.step(1)
    assert torch.equal(r.image, plain.image)
    assert len(calls) == 2 * (cfg.max_bounces + 1)
    assert "brute.lanes" in profiling.COUNTERS
    assert counts.pop("brute.lanes") == counts["intersect.lanes"] \
        == sum(calls[cfg.max_bounces + 1:])
    assert counts == plain_counts
    if cfg.compact:
        assert calls[-1] < cfg.width * cfg.height


def test_the_sweep_never_calls_the_kernel(monkeypatch):
    """The bunny (dispatch "auto": the cluster sweep) searches its spheres
    with ``golden.sphere_closest``, not through H1: no call, and
    ``brute.lanes`` stays 0."""
    scene, cam = bunny_like_scene(2, device="cpu")
    plain = Renderer(scene, cam, CFG, device="cpu")
    plain.step(1)
    calls = []
    monkeypatch.setattr(brute, "brute_hit_kernel", _stub(calls))
    monkeypatch.setattr(brute, "on_card", lambda t: True)
    r = Renderer(scene, cam, CFG, device="cpu")
    with profiling.counting() as counts:
        r.step(1)
    assert calls == [] and counts.get("brute.lanes", 0) == 0
    assert counts["intersect.lanes"] > 0
    assert torch.equal(r.image, plain.image)


def test_kernel_entry_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only: the CPU runs the twin."""
    scene, _ = _bsdf(device="cpu")
    sph, mesh = scene.spheres, scene.mesh
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        brute.brute_hit_kernel(z, z, sph.position, sph.radius, sph.count,
                               *golden.triangle_vertices(mesh), mesh.tri_draw,
                               mesh.draw_count, True)
