"""The Cornell box as quads: the raw scene of a configuration whose
``scene.loader`` is "cornell_quads".

The configuration lists the box's materials, its quads (four corners and a
material each), the two inner boxes (center, width, height, rotation) and
the camera; this module turns them into the raw arrays both sides are
given (perfbench/scenes/__init__.py describes them).  Each quad is two
triangles, (0, 1, 2) and (0, 2, 3).
"""

from __future__ import annotations

import numpy as np


def _box_quads(cx, cz, w, h, rot_deg, material):
    r = np.radians(rot_deg)
    cr, sr = np.cos(r), np.sin(r)
    half = w / 2.0
    (x0, z0), (x1, z1), (x2, z2), (x3, z3) = [
        (cx + dx * cr - dz * sr, cz + dx * sr + dz * cr)
        for dx, dz in ((-half, -half), (half, -half), (half, half),
                       (-half, half))]
    return [((x0, 0, z0), (x1, 0, z1), (x1, h, z1), (x0, h, z0), material),
            ((x1, 0, z1), (x2, 0, z2), (x2, h, z2), (x1, h, z1), material),
            ((x2, 0, z2), (x3, 0, z3), (x3, h, z3), (x2, h, z2), material),
            ((x3, 0, z3), (x0, 0, z0), (x0, h, z0), (x3, h, z3), material),
            ((x0, h, z0), (x1, h, z1), (x2, h, z2), (x3, h, z3), material)]


def load(scene: dict, root) -> dict:
    quads = [(*q["corners"], q["material"]) for q in scene["quads"]]
    for b in scene.get("boxes", []):
        quads += _box_quads(b["center_x"], b["center_z"], b["width"],
                            b["height"], b["rotation_deg"], b["material"])
    verts, idx, tri_material = [], [], []
    for p0, p1, p2, p3, mat in quads:
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
        tri_material.extend([mat, mat])
    return dict(materials=scene["materials"],
                vertices=np.asarray(verts, np.float32),
                indices=np.asarray(idx, np.int32),
                normals=None,
                tri_material=np.asarray(tri_material, np.int32),
                spheres=scene.get("spheres", []),
                camera=scene["camera"])
