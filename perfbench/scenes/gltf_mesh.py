"""A triangle mesh read from a binary glTF (.glb) file: the raw scene of a
configuration whose ``scene.loader`` is "gltf_mesh".

A plain reader of what such a file holds (the JSON chunk, the BIN chunk,
accessors of positions, normals and indices, node transforms); the
mesh's glTF material becomes the configuration's ``mesh_material`` entry
with the file's base colour as its albedo, and the configuration adds the
other materials, the spheres and the camera.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
           5125: np.uint32, 5126: np.float32}
_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_glb(path):
    with open(path, "rb") as f:
        magic, _, length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"{path} is not a binary glTF file")
        doc, binary = None, b""
        while f.tell() < length:
            size, kind = struct.unpack("<II", f.read(8))
            chunk = f.read(size)
            if kind == 0x4E4F534A:
                doc = json.loads(chunk)
            elif kind == 0x004E4942:
                binary = chunk
    return doc, binary


def _accessor(doc, binary, index):
    acc = doc["accessors"][index]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _DTYPES[acc["componentType"]]
    n = _COUNTS[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or np.dtype(dtype).itemsize * n
    rows = [np.frombuffer(binary, dtype, n, offset + i * stride)
            for i in range(acc["count"])] \
        if stride != np.dtype(dtype).itemsize * n else \
        [np.frombuffer(binary, dtype, acc["count"] * n, offset)]
    return np.concatenate(rows).reshape(acc["count"], n)


def _transform(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32) @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def load(scene: dict, root) -> dict:
    doc, binary = _read_glb(os.path.join(root, scene["file"]))
    verts, norms, idx = [], [], []

    def emit(mesh_index, world):
        for prim in doc["meshes"][mesh_index]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            pos = _accessor(doc, binary, attrs["POSITION"]).astype(np.float32)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            nrm = (_accessor(doc, binary, attrs["NORMAL"]).astype(np.float32)
                   @ np.linalg.inv(world[:3, :3])) if "NORMAL" in attrs \
                else np.zeros_like(pos)
            base = sum(len(v) for v in verts)
            idx.append(_accessor(doc, binary, prim["indices"]).reshape(-1)
                       .astype(np.int64) + base)
            verts.append(pos)
            norms.append(nrm)

    def walk(node_index, parent):
        node = doc["nodes"][node_index]
        world = parent @ _transform(node)
        if "mesh" in node:
            emit(node["mesh"], world)
        for child in node.get("children", []):
            walk(child, world)

    for r in doc["scenes"][doc.get("scene", 0)]["nodes"]:
        walk(r, np.eye(4, dtype=np.float32))
    gm = doc["materials"][0]["pbrMetallicRoughness"]
    body = dict(scene["mesh_material"],
                albedo=[float(x) for x in gm["baseColorFactor"][:3]])
    materials = [body] + scene.get("materials", [])
    indices = np.concatenate(idx).astype(np.int32)
    return dict(materials=materials,
                vertices=np.concatenate(verts).astype(np.float32),
                indices=indices,
                normals=np.concatenate(norms).astype(np.float32),
                tri_material=np.zeros(len(indices) // 3, np.int32),
                spheres=scene.get("spheres", []),
                camera=scene["camera"])
