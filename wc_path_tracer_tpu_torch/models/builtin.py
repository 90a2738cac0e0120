"""Built-in scenes (port of the JAX package's models/builtin.py): the
reference default scene and the BASELINE config ladder.

- default_scene: the reference's startup scene (src/PathTracingRenderer.jai:
  322-342): 4 materials / 4 spheres (+ an optional OBJ mesh), including
  quirk §2.4(3) — the "glass" material stays METAL because SetDielectric
  never sets the type.
- single_triangle_scene: config (a) — one diffuse triangle + a light.
- cornell_box_scene: config (b) — diffuse quads, emissive area light.
- mesh_scene: config (c) — an OBJ mesh under a sky/ground setup.
- full_bsdf_scene: config (d) — every BSDF in one Cornell enclosure.
"""

from __future__ import annotations

import numpy as np

from wc_path_tracer_tpu_torch.models.obj import parse_obj
from wc_path_tracer_tpu_torch.scene.camera import Camera
from wc_path_tracer_tpu_torch.scene.types import (
    MATERIAL_DIELECTRIC, MATERIAL_GGX, MATERIAL_LAMBERTIAN, MATERIAL_METAL,
    SceneBuilder)
from wc_path_tracer_tpu_torch.utils.device import resolve_device


def default_scene(mesh_path: str | None = None, true_dielectric: bool = False,
                  device=None):
    """The reference startup scene (src/PathTracingRenderer.jai:322-342) ->
    Scene.  ``true_dielectric=True`` fixes quirk §2.4(3) and makes the
    "glass" material a real DIELECTRIC."""
    dev = resolve_device(device)
    b = SceneBuilder()
    # PushMaterial order: glass, Ground, Left, Right (:322-335)
    if true_dielectric:
        glass = b.add_material(MATERIAL_DIELECTRIC, albedo=(0.0, 0.5, 1.0),
                               roughness=0.07, ior=1.5)
    else:
        glass = b.set_dielectric((0.0, 0.5, 1.0), 0.07, 1.5)  # stays METAL
    ground = b.add_material(MATERIAL_METAL, albedo=(0.8, 0.8, 0.0),
                            roughness=1.0)
    left = b.add_material(MATERIAL_METAL, emission=(1.6, 1.6, 1.6),
                          emission_strength=1.0)
    right = b.set_metal((0.8, 0.6, 0.2), 0.75, 0.02)

    # spheres (:336-339)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, glass)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, left)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, right)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)

    if mesh_path is not None:
        m = parse_obj(mesh_path)
        # triangles hit material 0, matching pathTracer.comp:175
        b.add_mesh(m.vertices, m.indices, normals=m.normals, uvs=m.uvs,
                   tri_material=0)
    return b.build(dev)


def default_camera(device=None) -> Camera:
    return Camera.create(position=(0.0, 0.0, 0.0), yaw=-90.0, pitch=0.0,
                         fov=90.0, device=resolve_device(device))


def single_triangle_scene(device=None):
    """Config (a): one diffuse triangle and a small bright emissive sphere
    as the light, black sky.  Returns (Scene, Camera)."""
    dev = resolve_device(device)
    b = SceneBuilder()
    white = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.73, 0.73, 0.73))
    light = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 0.9, 0.8),
                           emission_strength=40.0)
    tri_v = np.array([[-0.6, -0.4, -1.5], [0.6, -0.4, -1.5],
                      [0.0, 0.6, -1.6]], np.float32)
    b.add_mesh(tri_v, np.array([0, 1, 2], np.int32), tri_material=white)
    b.add_sphere((0.8, 0.9, -0.8), 0.12, light)
    cam = Camera.create(position=(0.0, 0.0, 0.5), yaw=-90.0, pitch=0.0,
                        fov=60.0, device=dev)
    return b.build(dev), cam


def cornell_box_scene(with_boxes: bool = True, device=None):
    """The Cornell box as diffuse quads with an emissive ceiling light, in
    the classic 555-unit box.  Returns (Scene, Camera)."""
    dev = resolve_device(device)
    b = SceneBuilder()
    white = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.73, 0.73, 0.73))
    red = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.65, 0.05, 0.05))
    green = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.12, 0.45, 0.15))
    light = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.0, 0.0, 0.0),
                           emission=(1.0, 1.0, 1.0), emission_strength=15.0)

    S = 555.0
    verts = []
    idx = []
    trimat = []

    def add_quad(p0, p1, p2, p3, mat):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
        trimat.extend([mat, mat])

    add_quad((0, 0, 0), (S, 0, 0), (S, 0, -S), (0, 0, -S), white)          # floor
    add_quad((0, S, 0), (0, S, -S), (S, S, -S), (S, 0 + S, 0), white)      # ceiling
    add_quad((0, 0, -S), (S, 0, -S), (S, S, -S), (0, S, -S), white)        # back
    add_quad((0, 0, 0), (0, 0, -S), (0, S, -S), (0, S, 0), red)            # left (x=0)
    add_quad((S, 0, 0), (S, S, 0), (S, S, -S), (S, 0, -S), green)          # right
    add_quad((213, S - 1.0, -227), (343, S - 1.0, -227),
             (343, S - 1.0, -332), (213, S - 1.0, -332), light)            # light

    if with_boxes:
        def add_box(cx, cz, w, h, rot_deg, mat):
            r = np.radians(rot_deg)
            cr, sr = np.cos(r), np.sin(r)
            half = w / 2.0
            corners = []
            for dx, dz in ((-half, -half), (half, -half), (half, half), (-half, half)):
                x = cx + dx * cr - dz * sr
                z = cz + dx * sr + dz * cr
                corners.append((x, z))
            (x0, z0), (x1, z1), (x2, z2), (x3, z3) = corners
            # 4 sides + top
            add_quad((x0, 0, z0), (x1, 0, z1), (x1, h, z1), (x0, h, z0), mat)
            add_quad((x1, 0, z1), (x2, 0, z2), (x2, h, z2), (x1, h, z1), mat)
            add_quad((x2, 0, z2), (x3, 0, z3), (x3, h, z3), (x2, h, z2), mat)
            add_quad((x3, 0, z3), (x0, 0, z0), (x0, h, z0), (x3, h, z3), mat)
            add_quad((x0, h, z0), (x1, h, z1), (x2, h, z2), (x3, h, z3), mat)

        add_box(185, -169, 165, 165, -18.0, white)   # short box
        add_box(368, -351, 165, 330, 15.0, white)    # tall box

    b.add_mesh(np.asarray(verts, np.float32), np.asarray(idx, np.int32),
               tri_material=np.asarray(trimat, np.int32))
    cam = Camera.create(position=(278.0, 273.0, 800.0), yaw=-90.0, pitch=0.0,
                        fov=40.0, device=dev)
    return b.build(dev), cam


def mesh_scene(mesh_path: str, scale: float = 1.0, device=None):
    """Config (c): an OBJ mesh and a metal ground sphere under the gradient
    sky.  Returns (Scene, Camera)."""
    dev = resolve_device(device)
    b = SceneBuilder()
    body = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.7, 0.7, 0.7))
    ground = b.add_material(MATERIAL_METAL, albedo=(0.8, 0.8, 0.0),
                            roughness=1.0)
    m = parse_obj(mesh_path)
    v = m.vertices * np.float32(scale)
    # center on origin, sit on y=0
    center = (v.min(0) + v.max(0)) / 2
    v = v - center
    v[:, 1] -= v[:, 1].min()
    b.add_mesh(v, m.indices, normals=m.normals, uvs=m.uvs, tri_material=body)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    extent = float(np.abs(v).max())
    cam = Camera.create(position=(0.0, extent * 0.8, extent * 2.5),
                        yaw=-90.0, pitch=-15.0, fov=50.0, device=dev)
    return b.build(dev), cam


def full_bsdf_scene(device=None):
    """Config (d): one sphere per material model — METAL (fuzzy mirror,
    pathTracer.comp:256-262), DIELECTRIC (Fresnel/TIR/Beer-Lambert,
    :264-280), LAMBERTIAN and GGX — in the Cornell enclosure under its area
    light.  Returns (Scene, Camera)."""
    dev = resolve_device(device)
    b = SceneBuilder()
    white = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.73, 0.73, 0.73))
    red = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.65, 0.05, 0.05))
    green = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.12, 0.45, 0.15))
    light = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.0, 0.0, 0.0),
                           emission=(1.0, 1.0, 1.0), emission_strength=15.0)
    metal = b.add_material(MATERIAL_METAL, albedo=(0.9, 0.75, 0.3),
                           roughness=0.15)
    glass = b.add_material(MATERIAL_DIELECTRIC, albedo=(1.0, 1.0, 1.0),
                           ior=1.5, absorption=(0.1, 0.02, 0.02),
                           absorption_strength=0.02)
    diffuse = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.2, 0.4, 0.8))
    ggx = b.add_material(MATERIAL_GGX, albedo=(0.95, 0.95, 0.95),
                         roughness=0.3)

    S = 555.0
    verts: list = []
    idx: list = []
    trimat: list = []

    def add_quad(p0, p1, p2, p3, mat):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
        trimat.extend([mat, mat])

    add_quad((0, 0, 0), (S, 0, 0), (S, 0, -S), (0, 0, -S), white)
    add_quad((0, S, 0), (0, S, -S), (S, S, -S), (S, S, 0), white)
    add_quad((0, 0, -S), (S, 0, -S), (S, S, -S), (0, S, -S), white)
    add_quad((0, 0, 0), (0, 0, -S), (0, S, -S), (0, S, 0), red)
    add_quad((S, 0, 0), (S, S, 0), (S, S, -S), (S, 0, -S), green)
    add_quad((213, S - 1.0, -227), (343, S - 1.0, -227),
             (343, S - 1.0, -332), (213, S - 1.0, -332), light)
    b.add_mesh(np.asarray(verts, np.float32), np.asarray(idx, np.int32),
               tri_material=np.asarray(trimat, np.int32))

    r = 75.0
    b.add_sphere((120.0, r, -140.0), r, metal)
    b.add_sphere((278.0, r, -278.0), r, glass)
    b.add_sphere((430.0, r, -140.0), r, diffuse)
    b.add_sphere((278.0, r + 170.0, -400.0), r, ggx)

    cam = Camera.create(position=(278.0, 273.0, 800.0), yaw=-90.0, pitch=0.0,
                        fov=40.0, device=dev)
    return b.build(dev), cam
