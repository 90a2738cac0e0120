"""Minimal glTF 2.0 loader (.gltf JSON + .bin, and binary .glb).

The reference only loads OBJ (src/ModelLoader.jai); glTF support is a
BASELINE-mandated extension (config (c): "glTF triangle mesh via BVH
traversal").  Scope: triangle primitives with POSITION/NORMAL/TEXCOORD_0
attributes, uint8/16/32 indices, node hierarchy transforms, and
pbrMetallicRoughness materials mapped onto this framework's material model:

- metallic-rough surfaces -> MATERIAL_GGX (albedo=baseColor, roughness,
  metallic)
- rough non-metals (roughness ~ 1, metallic ~ 0) -> MATERIAL_LAMBERTIAN
- emissiveFactor -> emission with strength 1

No textures (factors only), no animation/skinning, no sparse accessors.
A copy of the JAX package's parser and ``gltf_scene``; the bunny scenes
that use the parser are built in models/procedural.py.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct

import numpy as np

from wc_path_tracer_tpu_torch.scene.camera import Camera
from wc_path_tracer_tpu_torch.scene.types import (
    MATERIAL_GGX, MATERIAL_LAMBERTIAN, SceneBuilder)
from wc_path_tracer_tpu_torch.utils.device import resolve_device

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT4": 16}


@dataclasses.dataclass
class GltfMesh:
    vertices: np.ndarray   # (V, 3) f32, world-transformed
    normals: np.ndarray    # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (I,) i32
    material: int          # index into materials list


@dataclasses.dataclass
class GltfModel:
    meshes: list
    materials: list  # dicts: albedo, roughness, metallic, emission


def _load_buffers(doc, base_dir, glb_bin):
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc, buffers, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    data = buffers[view["buffer"]]
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        rows = []
        for i in range(count):
            start = offset + i * stride
            rows.append(np.frombuffer(data, dtype, ncomp, start))
        arr = np.stack(rows)
    else:
        arr = np.frombuffer(data, dtype, count * ncomp, offset).reshape(count, ncomp)
    return np.array(arr)


def _node_transform(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def parse_gltf(path: str) -> GltfModel:
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":  # binary .glb container
            magic, version, length = struct.unpack("<III", f.read(12))
            doc = None
            glb_bin = b""
            while f.tell() < length:
                clen, ctype = struct.unpack("<II", f.read(8))
                chunk = f.read(clen)
                if ctype == 0x4E4F534A:       # 'JSON'
                    doc = json.loads(chunk)
                elif ctype == 0x004E4942:     # 'BIN'
                    glb_bin = chunk
        else:
            doc = json.load(open(path))
            glb_bin = b""

    base_dir = os.path.dirname(os.path.abspath(path))
    buffers = _load_buffers(doc, base_dir, glb_bin)

    materials = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])[:3]
        materials.append(dict(
            albedo=tuple(base),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            emission=tuple(m.get("emissiveFactor", [0, 0, 0])),
        ))
    if not materials:
        materials.append(dict(albedo=(0.8, 0.8, 0.8), roughness=1.0,
                              metallic=0.0, emission=(0, 0, 0)))

    meshes = []

    def emit_mesh(mesh_idx, world):
        nrm_mat = np.linalg.inv(world[:3, :3]).T
        for prim in doc["meshes"][mesh_idx].get("primitives", []):
            if prim.get("mode", 4) != 4:   # triangles only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                nrm = nrm @ nrm_mat.T
            else:
                nrm = np.zeros_like(pos)
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
            else:
                uv = np.zeros((len(pos), 2), np.float32)
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.int32)
            else:
                idx = np.arange(len(pos), dtype=np.int32)
            meshes.append(GltfMesh(pos, nrm, uv, idx,
                                   int(prim.get("material", 0))))

    scenes = doc.get("scenes", [])
    scene_idx = doc.get("scene", 0)
    roots = scenes[scene_idx]["nodes"] if scenes else range(len(doc.get("nodes", [])))

    def walk(node_idx, parent):
        node = doc["nodes"][node_idx]
        world = parent @ _node_transform(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world)
        for ch in node.get("children", []):
            walk(ch, world)

    if doc.get("nodes"):
        for r in roots:
            walk(r, np.eye(4, dtype=np.float32))
    else:
        for i in range(len(doc.get("meshes", []))):
            emit_mesh(i, np.eye(4, dtype=np.float32))

    return GltfModel(meshes=meshes, materials=materials)


def gltf_scene(path: str, device=None):
    """A renderable (Scene, Camera) from a glTF file: its meshes with their
    materials, and a camera framing their bounds."""
    dev = resolve_device(device)
    model = parse_gltf(path)
    b = SceneBuilder()
    mat_ids = []
    for m in model.materials:
        if m["metallic"] < 0.05 and m["roughness"] > 0.9:
            mat_ids.append(b.add_material(
                MATERIAL_LAMBERTIAN, albedo=m["albedo"],
                emission=m["emission"],
                emission_strength=1.0 if any(m["emission"]) else 0.0))
        else:
            mat_ids.append(b.add_material(
                MATERIAL_GGX, albedo=m["albedo"], roughness=m["roughness"],
                metallic=m["metallic"], emission=m["emission"],
                emission_strength=1.0 if any(m["emission"]) else 0.0))

    all_pts = []
    for mesh in model.meshes:
        b.add_mesh(mesh.vertices, mesh.indices, normals=mesh.normals,
                   uvs=mesh.uvs, tri_material=mat_ids[mesh.material])
        all_pts.append(mesh.vertices)
    pts = np.concatenate(all_pts) if all_pts else np.zeros((1, 3), np.float32)
    center = (pts.min(0) + pts.max(0)) / 2
    extent = float(np.abs(pts - center).max()) or 1.0
    cam = Camera.create(
        position=(center[0], center[1] + 0.5 * extent,
                  center[2] + 2.5 * extent),
        yaw=-90.0, pitch=-10.0, fov=50.0, device=dev)
    return b.build(dev), cam
