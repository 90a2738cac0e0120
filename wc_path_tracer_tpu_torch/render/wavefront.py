"""BVH-walk renderers (port of the JAX package's render/wavefront.py).

Only the closest-hit query differs from render/golden.py: spheres are
searched brute force (``golden.sphere_closest``), triangles by a walk of
each draw's BVH (kernels/traversal.py), and the winner is re-shaded
differentiably from its own vertices by ``golden.resolve_hit``, the
selection rules of the brute path.

- ``render_frame`` (dispatch "wavefront"): the plain PyTorch walks,
  ``cfg.traversal`` "stack" (per-lane stack, near child first) or
  "stackless" (escape links, fixed order).
- ``render_frame_pallas`` (dispatch "pallas"): the stack walk through the
  hand-written CUDA kernel (``traversal.bvh_walk_kernel``), which walks
  each ray on its own over every draw in one launch, and only the lanes the
  transport has not terminated (``accepts_alive``).  The JAX package padded
  rays to its 1024-lane packet and split big banks into SMEM-sized chunks;
  the kernel needs neither.

The walks are discrete searches on detached values and return the winner's
first-index offset; gradients flow through the re-shade, which recovers the
winner's vertices through ``mesh.tri_draw``.  Neither backend registers an
``occlusion_fn`` (as in the JAX package), so NEE's shadow rays take the
full closest hit: on "pallas" one more walk per bounce, of the lanes that
sample a light only.
"""

from __future__ import annotations

from wc_path_tracer_tpu_torch.kernels import traversal
from wc_path_tracer_tpu_torch.render import golden
from wc_path_tracer_tpu_torch.scene.types import Scene
from wc_path_tracer_tpu_torch.utils.config import RenderConfig


def _reshade(scene: Scene, origin, direction, cfg: RenderConfig, sphere,
             t_tri, best_off) -> golden.HitRecord:
    """HitRecord from the sphere winner and the walk's (t, offset): the
    triangle's vertices come from its index triple rebased by its draw's
    vertex offset (found through ``tri_draw``)."""
    mesh = scene.mesh
    tri_hit = best_off >= 0
    off = best_off.long().clamp_min(0)
    tri = off // 3
    voff = mesh.draw_vertex_offset[mesh.tri_draw[tri].clamp_min(0)].long()
    # index_select: its backward (index_add_) does not serialize the lanes
    # that share a vertex
    a, b, c = (mesh.vertices.index_select(
        0, voff + mesh.indices[off + k].long()) for k in range(3))
    return golden.resolve_hit(origin, direction, cfg, *sphere, t_tri,
                              tri_hit, a, b, c, mesh.tri_material[tri])


def intersect_scene_bvh(scene: Scene, origin, direction,
                        cfg: RenderConfig) -> golden.HitRecord:
    """Closest hit through the plain PyTorch BVH walk named by
    ``cfg.traversal``; the brute path's selection semantics."""
    sphere = golden.sphere_closest(scene, origin, direction, cfg)
    walk = (traversal.bvh_walk_stackless_plain if cfg.traversal == "stackless"
            else traversal.bvh_walk_plain)
    t_tri, off = walk(origin, direction, sphere[0], scene.mesh)
    return _reshade(scene, origin, direction, cfg, sphere, t_tri, off)


def intersect_scene_pallas(scene: Scene, origin, direction, cfg: RenderConfig,
                           walk_fn=None, alive=None) -> golden.HitRecord:
    """Closest hit through the BVH-walk kernel (any ray count).  ``walk_fn``
    overrides the walk (default ``traversal.bvh_walk_kernel``, which runs
    the plain walk on CPU tensors); it takes ``alive=`` when given.
    ``alive``: optional (R,) bool of lanes the transport has not
    terminated; the others are not walked (``t`` stays the sphere search's,
    no triangle hit).  CONTRACT: on non-alive lanes the record is
    undefined; every consumer masks it, as golden._bounce_segment does (the
    JAX package's ``accepts_alive`` contract)."""
    sphere = golden.sphere_closest(scene, origin, direction, cfg)
    walk = traversal.bvh_walk_kernel if walk_fn is None else walk_fn
    kw = {} if alive is None else dict(alive=alive)
    t_tri, off = walk(origin.detach().contiguous(),
                      direction.detach().contiguous(), sphere[0].contiguous(),
                      scene.mesh, **kw)
    return _reshade(scene, origin, direction, cfg, sphere, t_tri, off)


intersect_scene_pallas.accepts_alive = True


def make_intersect_fn_pallas(scene: Scene, walk_fn=None):
    """intersect_fn for golden's transport through ``walk_fn`` (default the
    kernel walk; it must take ``alive=``), after checking that every BVH of
    the scene fits the walk's stack."""
    traversal.check_stack_depth(scene.mesh)

    def fn(scene, origin, direction, cfg, alive=None):
        return intersect_scene_pallas(scene, origin, direction, cfg, walk_fn,
                                      alive)

    fn.accepts_alive = True
    return fn


def trace_rays(scene, origin, direction, seed, cfg):
    return golden.trace_rays(scene, origin, direction, seed, cfg,
                             intersect_fn=intersect_scene_bvh)


def render_rows(scene, mats, cfg, frame_count, y0, num_rows):
    return golden.render_rows(scene, mats, cfg, frame_count, y0, num_rows,
                              intersect_fn=intersect_scene_bvh)


def render_frame(scene, mats, cfg, frame_count):
    """One frame through the plain BVH walk of ``cfg.traversal``."""
    return golden.render_frame(scene, mats, cfg, frame_count,
                               intersect_fn=intersect_scene_bvh)


def render_rows_pallas(scene, mats, cfg, frame_count, y0, num_rows):
    """Rows [y0, y0 + num_rows) with the BVH-walk kernel as the closest-hit
    backend."""
    return golden.render_rows(scene, mats, cfg, frame_count, y0, num_rows,
                              intersect_fn=make_intersect_fn_pallas(scene))


def render_frame_pallas(scene, mats, cfg, frame_count):
    """One frame with the BVH-walk kernel as the closest-hit backend
    (dispatch name "pallas"), walking only live lanes.  The kernel's tables
    are packed on the scene's first walk only (``traversal.walk_tables``)."""
    return golden.render_frame(scene, mats, cfg, frame_count,
                               intersect_fn=intersect_scene_pallas)
