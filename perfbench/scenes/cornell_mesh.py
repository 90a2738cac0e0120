"""The Cornell box with a triangle mesh inside it: the raw scene of a
configuration whose ``scene.loader`` is "cornell_mesh".

The configuration lists the materials, the box's quads and the camera, as
"cornell_quads" reads them, and one ``mesh``: a binary glTF file (read by
"gltf_mesh", node transforms included), a uniform ``scale`` about the
origin, then a ``translation``, and the ``material`` of every one of its
triangles.  The quads' triangles come first, then the mesh's, in one set of
vertex and index arrays.  The quads' vertices carry zero normals: both
sides shade with flat normals, so normals change no pixel.  Materials come
from the configuration alone (the mesh file's own material is not read).
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes import cornell_quads, gltf_mesh


def load(scene: dict, root) -> dict:
    box = cornell_quads.load(dict(scene, boxes=[]), root)
    spec = scene["mesh"]
    mesh = gltf_mesh.load({"file": spec["file"], "mesh_material": {},
                           "camera": scene["camera"]}, root)
    verts = (mesh["vertices"] * np.float32(spec["scale"])
             + np.asarray(spec["translation"], np.float32))
    n_box = len(box["vertices"])
    n_tris = len(mesh["indices"]) // 3
    return dict(
        box,
        vertices=np.concatenate([box["vertices"], verts]).astype(np.float32),
        indices=np.concatenate([box["indices"],
                                mesh["indices"] + n_box]).astype(np.int32),
        normals=np.concatenate([np.zeros_like(box["vertices"]),
                                mesh["normals"]]).astype(np.float32),
        tri_material=np.concatenate([
            box["tri_material"],
            np.full(n_tris, spec["material"], np.int32)]).astype(np.int32))
