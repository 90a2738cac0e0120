"""Wavefront OBJ parser (a copy of the JAX package's models/obj.py).

Semantics match the reference's parser (src/ModelLoader.jai:60-141):

- handles ``v``/``vt``/``vn``/``f`` records, ignores everything else
- a face vertex is the triple (v, vt, vn) of 1-based indices (missing
  entries allowed); identical triples are deduplicated into one output vertex
- polygons are fan-triangulated: (0, i, i+1) for i in 1..n-2 (:132-136)
- out-of-range indices leave the attribute zero (matching the reference's
  bounds-checked copies, :117-119)

``load_obj`` parses with the native C++ parser of scene/native.py, whose
results equal ``parse_obj``'s (tests/test_torch_native.py), and falls back
to ``parse_obj`` where the library cannot be built, as the JAX package's
does; the scene builders of models/builtin.py call ``parse_obj``, as the
JAX package's do.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ObjModel:
    vertices: np.ndarray   # (V, 3) f32 positions
    normals: np.ndarray    # (V, 3) f32 (zero when absent)
    uvs: np.ndarray        # (V, 2) f32 (zero when absent)
    indices: np.ndarray    # (I,) i32 triangle list


def load_obj(path: str) -> ObjModel:
    """Parse an OBJ file with the native parser (``parse_obj``'s results;
    ``parse_obj`` itself where the library is unavailable)."""
    from wc_path_tracer_tpu_torch.scene.native import parse_obj_native
    return parse_obj_native(path)


def parse_obj(path_or_text: str, from_text: bool = False) -> ObjModel:
    if from_text:
        text = path_or_text
    else:
        with open(path_or_text, "r", errors="replace") as f:
            text = f.read()

    positions: list = []
    texcoords: list = []
    normals: list = []

    out_pos: list = []
    out_uv: list = []
    out_nrm: list = []
    indices: list = []
    vertex_map: dict = {}

    for line in text.split("\n"):
        t = line.strip()
        if not t or t.startswith("#"):
            continue
        tok = t.split()
        cmd = tok[0]
        if cmd == "v" and len(tok) >= 4:
            positions.append((float(tok[1]), float(tok[2]), float(tok[3])))
        elif cmd == "vt" and len(tok) >= 3:
            texcoords.append((float(tok[1]), float(tok[2])))
        elif cmd == "vn" and len(tok) >= 4:
            normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
        elif cmd == "f" and len(tok) >= 4:
            face: list = []
            for w in tok[1:]:
                parts = w.split("/")
                v = int(parts[0]) - 1 if len(parts) >= 1 and parts[0] else -1
                vt = int(parts[1]) - 1 if len(parts) >= 2 and parts[1] else -1
                vn = int(parts[2]) - 1 if len(parts) >= 3 and parts[2] else -1
                key = (v, vt, vn)
                idx = vertex_map.get(key)
                if idx is None:
                    idx = len(out_pos)
                    vertex_map[key] = idx
                    out_pos.append(positions[v] if 0 <= v < len(positions)
                                   else (0.0, 0.0, 0.0))
                    out_uv.append(texcoords[vt] if 0 <= vt < len(texcoords)
                                  else (0.0, 0.0))
                    out_nrm.append(normals[vn] if 0 <= vn < len(normals)
                                   else (0.0, 0.0, 0.0))
                face.append(idx)
            for i in range(1, len(face) - 1):  # fan triangulation (:132-136)
                indices.extend((face[0], face[i], face[i + 1]))

    return ObjModel(
        vertices=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(-1, 3),
        uvs=np.asarray(out_uv, np.float32).reshape(-1, 2),
        indices=np.asarray(indices, np.int32),
    )
