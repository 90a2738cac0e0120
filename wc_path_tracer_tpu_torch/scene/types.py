"""Scene data model: structure-of-arrays tensors padded to fixed capacities.

The port of ``wc_path_tracer_tpu/scene/types.py``.  The JAX package pads
every array to a power-of-two capacity and carries live counts as int32
scalars so that edits never change a shape; the port keeps the same layout,
the same padding and the same capacities, so one scene has bit-identical
leaves in both packages (tests/test_torch_scene.py).

Material type ids 0/1 match the reference enum (pathTracer.comp:32-33);
2 (Lambertian) and 3 (rough GGX conductor) are extensions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wc_path_tracer_tpu_torch.scene import native
from wc_path_tracer_tpu_torch.scene.bvh import split_mesh
from wc_path_tracer_tpu_torch.utils.device import resolve_device

MATERIAL_METAL = 0        # pathTracer.comp:32
MATERIAL_DIELECTRIC = 1   # pathTracer.comp:33
MATERIAL_LAMBERTIAN = 2   # extension: cosine-weighted diffuse
MATERIAL_GGX = 3          # extension: GGX microfacet conductor

F32_MAX = np.finfo(np.float32).max


def _moved(obj, device):
    """Copy of a tensor dataclass with every tensor field on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass
class Materials:
    """SoA mirror of the reference Material struct (pathTracer.comp:35-47)."""

    mtype: torch.Tensor                # (M,) int32
    albedo: torch.Tensor               # (M, 3) f32
    emission: torch.Tensor             # (M, 3) f32
    emission_strength: torch.Tensor    # (M,) f32
    metallic: torch.Tensor             # (M,) f32
    roughness: torch.Tensor            # (M,) f32
    absorption: torch.Tensor           # (M, 3) f32
    absorption_strength: torch.Tensor  # (M,) f32
    ior: torch.Tensor                  # (M,) f32
    count: torch.Tensor                # () int32 — live materials

    @property
    def capacity(self) -> int:
        return self.mtype.shape[0]

    @staticmethod
    def empty(capacity: int, device=None) -> "Materials":
        """No live materials: the reference struct defaults
        (src/PathTracingRenderer.jai:58-70), absorption_strength and ior 1,
        everything else 0 (type METAL)."""
        dev = resolve_device(device)

        def z(*shape):
            return torch.zeros((capacity,) + shape, device=dev)
        return Materials(
            mtype=torch.zeros(capacity, dtype=torch.int32, device=dev),
            albedo=z(3), emission=z(3), emission_strength=z(), metallic=z(),
            roughness=z(), absorption=z(3),
            absorption_strength=torch.ones(capacity, device=dev),
            ior=torch.ones(capacity, device=dev),
            count=torch.tensor(0, dtype=torch.int32, device=dev))

    def to(self, device) -> "Materials":
        return _moved(self, device)


@dataclasses.dataclass
class Spheres:
    """SoA mirror of the reference Sphere struct (pathTracer.comp:60-64)."""

    position: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor    # (S,) f32
    material: torch.Tensor  # (S,) int32
    count: torch.Tensor     # () int32

    @property
    def capacity(self) -> int:
        return self.radius.shape[0]

    @staticmethod
    def empty(capacity: int, device=None) -> "Spheres":
        """No live spheres, every slot zero."""
        dev = resolve_device(device)
        return Spheres(
            position=torch.zeros((capacity, 3), device=dev),
            radius=torch.zeros(capacity, device=dev),
            material=torch.zeros(capacity, dtype=torch.int32, device=dev),
            count=torch.tensor(0, dtype=torch.int32, device=dev))

    def to(self, device) -> "Spheres":
        return _moved(self, device)


@dataclasses.dataclass
class MeshBank:
    """All triangle meshes flattened into one shared bank (see the JAX
    package's MeshBank for the field semantics: draw commands hold offsets
    into the shared padded arrays; ``tri_draw`` is -1 on padding slots)."""

    vertices: torch.Tensor            # (V, 3) f32
    normals: torch.Tensor             # (V, 3) f32
    uvs: torch.Tensor                 # (V, 2) f32
    indices: torch.Tensor             # (I,) int32 — triangle list, stride 3
    tri_material: torch.Tensor        # (I//3,) int32
    tri_draw: torch.Tensor            # (I//3,) int32 (-1 = padding)
    tri_neighbor: torch.Tensor        # (I//3, 3) int32 (-1 = boundary)
    bvh_min: torch.Tensor             # (N, 3) f32
    bvh_max: torch.Tensor             # (N, 3) f32
    bvh_left: torch.Tensor            # (N,) int32
    bvh_count: torch.Tensor           # (N,) int32 — index count, 0 = inner
    bvh_escape: torch.Tensor          # (N,) int32
    draw_vertex_offset: torch.Tensor  # (D,) int32
    draw_index_offset: torch.Tensor   # (D,) int32
    draw_node_offset: torch.Tensor    # (D,) int32
    draw_index_count: torch.Tensor    # (D,) int32
    draw_count: torch.Tensor          # () int32
    max_leaf_tris: int = 2            # largest BVH leaf, in triangles

    @property
    def vertex_capacity(self) -> int:
        return self.vertices.shape[0]

    @property
    def index_capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def node_capacity(self) -> int:
        return self.bvh_min.shape[0]

    @property
    def draw_capacity(self) -> int:
        return self.draw_index_count.shape[0]

    @property
    def triangle_capacity(self) -> int:
        return self.indices.shape[0] // 3

    @staticmethod
    def empty(vertex_capacity: int = 8, index_capacity: int = 24,
              node_capacity: int = 8, draw_capacity: int = 1,
              device=None) -> "MeshBank":
        """No draws: the padding ``SceneBuilder.build`` writes (``tri_draw``
        and ``bvh_escape`` -1, boxes inverted at +-FLT_MAX), the index
        capacity rounded up to a multiple of 3."""
        dev = resolve_device(device)
        index_capacity = 3 * ((index_capacity + 2) // 3)
        T = index_capacity // 3

        def full(shape, value, dtype=torch.int32):
            return torch.full(shape, value, dtype=dtype, device=dev)
        return MeshBank(
            vertices=full((vertex_capacity, 3), 0.0, torch.float32),
            normals=full((vertex_capacity, 3), 0.0, torch.float32),
            uvs=full((vertex_capacity, 2), 0.0, torch.float32),
            indices=full((index_capacity,), 0),
            tri_material=full((T,), 0), tri_draw=full((T,), -1),
            tri_neighbor=full((T, 3), -1),
            bvh_min=full((node_capacity, 3), F32_MAX, torch.float32),
            bvh_max=full((node_capacity, 3), -F32_MAX, torch.float32),
            bvh_left=full((node_capacity,), 0),
            bvh_count=full((node_capacity,), 0),
            bvh_escape=full((node_capacity,), -1),
            draw_vertex_offset=full((draw_capacity,), 0),
            draw_index_offset=full((draw_capacity,), 0),
            draw_node_offset=full((draw_capacity,), 0),
            draw_index_count=full((draw_capacity,), 0),
            draw_count=full((), 0), max_leaf_tris=1)

    def to(self, device) -> "MeshBank":
        return _moved(self, device)


@dataclasses.dataclass
class Scene:
    materials: Materials
    spheres: Spheres
    mesh: MeshBank

    @property
    def device(self) -> torch.device:
        return self.mesh.vertices.device

    @staticmethod
    def empty(material_capacity: int = 8, sphere_capacity: int = 8,
              mesh: MeshBank | None = None, device=None) -> "Scene":
        """A scene with nothing in it (``mesh`` None: ``MeshBank.empty()``);
        it renders the sky alone."""
        return Scene(materials=Materials.empty(material_capacity, device),
                     spheres=Spheres.empty(sphere_capacity, device),
                     mesh=mesh if mesh is not None
                     else MeshBank.empty(device=device))

    def to(self, device) -> "Scene":
        return Scene(self.materials.to(device), self.spheres.to(device),
                     self.mesh.to(device))


_GROUPS = (("materials", Materials), ("spheres", Spheres), ("mesh", MeshBank))


def leaf_names() -> list[str]:
    """Keys of ``scene_from_numpy``'s leaves: ``"<group>.<field>"`` for every
    tensor field, e.g. ``"materials.albedo"`` or ``"mesh.vertices"``."""
    return [f"{g}.{f.name}" for g, cls in _GROUPS
            for f in dataclasses.fields(cls) if f.name != "max_leaf_tris"]


def scene_from_numpy(leaves: dict[str, np.ndarray], max_leaf_tris: int,
                     device=None) -> Scene:
    """Build a Scene from NumPy leaves keyed as ``leaf_names()`` — e.g. the
    leaves of a JAX package Scene, converted with ``np.asarray``.  Dtypes
    and values are kept exactly."""
    names = leaf_names()
    if set(leaves) != set(names):
        raise ValueError(
            f"scene leaves differ: missing {sorted(set(names) - set(leaves))}"
            f", unexpected {sorted(set(leaves) - set(names))}")
    dev = resolve_device(device)

    def group(prefix, cls, **extra):
        return cls(**{
            f.name: torch.from_numpy(
                np.array(leaves[f"{prefix}.{f.name}"])).to(dev)
            for f in dataclasses.fields(cls) if f.name != "max_leaf_tris"},
            **extra)

    return Scene(materials=group("materials", Materials),
                 spheres=group("spheres", Spheres),
                 mesh=group("mesh", MeshBank, max_leaf_tris=max_leaf_tris))


class SceneBuilder:
    """Accumulates materials/spheres/meshes on the host, then pads them into
    a Scene with the JAX package's capacities and fill values."""

    def __init__(self):
        self.materials: list[dict] = []
        self.spheres: list[tuple] = []
        self.meshes: list[dict] = []

    def add_material(self, mtype=MATERIAL_METAL, albedo=(0, 0, 0),
                     emission=(0, 0, 0), emission_strength=0.0, metallic=0.0,
                     roughness=0.0, absorption=(0, 0, 0),
                     absorption_strength=1.0, ior=1.0) -> int:
        self.materials.append(dict(
            mtype=mtype, albedo=albedo, emission=emission,
            emission_strength=emission_strength, metallic=metallic,
            roughness=roughness, absorption=absorption,
            absorption_strength=absorption_strength, ior=ior))
        return len(self.materials) - 1

    def set_metal(self, albedo, roughness, metallic=0.0) -> int:
        """Reference SetMetal (src/PathTracingRenderer.jai:72-76)."""
        return self.add_material(MATERIAL_METAL, albedo=albedo,
                                 roughness=roughness, metallic=metallic)

    def set_dielectric(self, color, roughness, ior) -> int:
        """Reference SetDielectric, which does not set the type field
        (src/PathTracingRenderer.jai:78-82, quirk §2.4(3)): the material
        stays METAL.  add_material(MATERIAL_DIELECTRIC, ...) makes a real
        dielectric."""
        return self.add_material(MATERIAL_METAL, albedo=color,
                                 roughness=roughness, ior=ior)

    def add_sphere(self, position, radius, material: int) -> int:
        self.spheres.append((position, radius, material))
        return len(self.spheres) - 1

    def add_mesh(self, vertices, indices, normals=None, uvs=None,
                 tri_material=0, bvh=None, robust_bvh=True,
                 max_blas_tris=None) -> int:
        """Add a triangle mesh.  ``bvh`` is a scene.bvh.BVH of it (built if
        None, by the native builder of scene/native.py, whose trees equal
        the NumPy builder's; ``bvh_builders`` records which built it).
        ``max_blas_tris`` splits a mesh without a given ``bvh`` spatially
        into draws of at most that many triangles.  Returns the first draw
        id."""
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int32).reshape(-1)
        ntris = len(indices) // 3
        if max_blas_tris is not None and ntris > max_blas_tris \
                and bvh is None:
            tri_material = np.broadcast_to(
                np.asarray(tri_material, np.int32), (ntris,))
            first = len(self.meshes)
            for sub_v, sub_i, tri_ids in split_mesh(
                    vertices, indices, max_blas_tris):
                self.add_mesh(sub_v, sub_i, tri_material=tri_material[tri_ids],
                              robust_bvh=robust_bvh)
            return first
        if bvh is None:
            bvh = native.build_bvh_native(vertices, indices,
                                          robust=robust_bvh)
            how = "native" if native.available() else "numpy"
        else:
            how = "given"
        tri_material = np.broadcast_to(
            np.asarray(tri_material, np.int32), (ntris,)).copy()
        self.meshes.append(dict(
            vertices=vertices, indices=indices,
            normals=np.zeros_like(vertices) if normals is None
            else np.asarray(normals, np.float32).reshape(-1, 3),
            uvs=np.zeros((len(vertices), 2), np.float32) if uvs is None
            else np.asarray(uvs, np.float32).reshape(-1, 2),
            tri_material=tri_material, bvh=bvh, bvh_builder=how))
        return len(self.meshes) - 1

    @property
    def bvh_builders(self) -> list[str]:
        """Per draw, what built its BVH: "native" (scene/native.py's
        library), "numpy" (its fallback, scene/bvh.py) or "given" (the
        caller's ``bvh``)."""
        return [m["bvh_builder"] for m in self.meshes]

    def build(self, device=None) -> Scene:
        dev = resolve_device(device)
        leaves = {}
        mats = _host_leaves(Materials.empty(
            _round_up_pow2(max(len(self.materials), 1)), "cpu"))
        for i, m in enumerate(self.materials):
            for k, col in mats.items():
                if k != "count":
                    col[i] = m[k]
        mats["count"] = np.asarray(len(self.materials), np.int32)
        leaves.update({f"materials.{k}": v for k, v in mats.items()})

        sph = _host_leaves(Spheres.empty(
            _round_up_pow2(max(len(self.spheres), 1)), "cpu"))
        for i, (p, r, m) in enumerate(self.spheres):
            sph["position"][i], sph["radius"][i], sph["material"][i] = p, r, m
        sph["count"] = np.asarray(len(self.spheres), np.int32)
        leaves.update({f"spheres.{k}": v for k, v in sph.items()})

        mesh, max_leaf = self._mesh_leaves()
        leaves.update({f"mesh.{k}": v for k, v in mesh.items()})
        return scene_from_numpy(leaves, max_leaf, dev)

    def _mesh_leaves(self):
        nv = sum(len(m["vertices"]) for m in self.meshes)
        ni = sum(len(m["indices"]) for m in self.meshes)
        nn = sum(len(m["bvh"].node_min) for m in self.meshes)
        vcap = _round_up_pow2(max(nv, 8))
        icap = 3 * ((_round_up_pow2(max(ni, 24)) + 2) // 3)
        ncap = _round_up_pow2(max(nn, 8))
        dcap = _round_up_pow2(max(len(self.meshes), 1))
        out = _host_leaves(MeshBank.empty(vcap, icap, ncap, dcap, "cpu"))
        out["draw_count"] = np.asarray(len(self.meshes), np.int32)
        if not self.meshes:
            return out, 1

        vo = io = no = 0
        for d, m in enumerate(self.meshes):
            bvh = m["bvh"]
            V, I, N = len(m["vertices"]), len(m["indices"]), len(bvh.node_min)
            t0, t1 = io // 3, (io + I) // 3
            out["vertices"][vo:vo + V] = m["vertices"]
            out["normals"][vo:vo + V] = m["normals"]
            out["uvs"][vo:vo + V] = m["uvs"]
            out["indices"][io:io + I] = bvh.indices   # BVH-reordered
            out["tri_material"][t0:t1] = m["tri_material"][bvh.tri_order]
            out["tri_draw"][t0:t1] = d
            nbr = triangle_neighbors(m["vertices"], bvh.indices)
            out["tri_neighbor"][t0:t1] = np.where(nbr >= 0, nbr + t0, -1)
            out["bvh_min"][no:no + N] = bvh.node_min
            out["bvh_max"][no:no + N] = bvh.node_max
            out["bvh_left"][no:no + N] = bvh.node_left
            out["bvh_count"][no:no + N] = bvh.node_count
            out["bvh_escape"][no:no + N] = escape_links(
                bvh.node_left, bvh.node_count)
            out["draw_vertex_offset"][d] = vo
            out["draw_index_offset"][d] = io
            out["draw_node_offset"][d] = no
            out["draw_index_count"][d] = I
            vo, io, no = vo + V, io + I, no + N

        most = int(np.max(out["bvh_count"]))
        return out, max(1, most // 3 + (most % 3 > 0))


def triangle_neighbors(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(T, 3) int32 neighbor triangle ids (mesh-local), -1 = boundary.

    Edge k of triangle t spans its vertices (k, (k+1)%3).  Adjacency is keyed
    on vertex POSITIONS (exact bitwise match); an edge shared by exactly two
    triangles links them, boundary and non-manifold edges stay -1.
    """
    tri = np.asarray(indices, np.int64).reshape(-1, 3)
    T = len(tri)
    nbr = np.full((T, 3), -1, np.int32)
    if T == 0:
        return nbr
    _, vkey = np.unique(np.asarray(vertices, np.float32)[..., :3],
                        axis=0, return_inverse=True)
    vkey = vkey.reshape(-1)
    k = vkey[tri]                                   # (T, 3)
    e0 = np.stack([k[:, 0], k[:, 1]], 1)
    e1 = np.stack([k[:, 1], k[:, 2]], 1)
    e2 = np.stack([k[:, 2], k[:, 0]], 1)
    edges = np.sort(np.concatenate([e0, e1, e2]), axis=1)   # (3T, 2)
    keys = edges[:, 0] * (vkey.max() + 1) + edges[:, 1]
    owner_tri = np.tile(np.arange(T), 3)
    owner_slot = np.repeat(np.arange(3), T)
    uniq, inv, counts = np.unique(keys, return_inverse=True,
                                  return_counts=True)
    order = np.argsort(inv, kind="stable")
    starts = np.zeros(len(uniq), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    for g in np.where(counts == 2)[0]:
        i0, i1 = order[starts[g]], order[starts[g] + 1]
        t0, s0 = owner_tri[i0], owner_slot[i0]
        t1, s1 = owner_tri[i1], owner_slot[i1]
        if t0 != t1:
            nbr[t0, s0] = t1
            nbr[t1, s1] = t0
    return nbr


def escape_links(node_left: np.ndarray, node_count: np.ndarray) -> np.ndarray:
    """DFS escape links for stackless BVH traversal (mesh-local indices):
    escape(left) = right sibling, escape(right) = escape(parent), -1 = done."""
    n = len(node_left)
    esc = np.full(n, -1, np.int32)
    if n == 0:
        return esc
    stack = [(0, -1)]
    while stack:
        node, e = stack.pop()
        esc[node] = e
        if node_count[node] == 0:  # inner
            left = int(node_left[node])
            stack.append((left + 1, e))
            stack.append((left, left + 1))
    return esc


def _host_leaves(table) -> dict[str, np.ndarray]:
    """The tensor fields of a CPU table as writable NumPy arrays (views)."""
    return {f.name: getattr(table, f.name).numpy()
            for f in dataclasses.fields(table)
            if isinstance(getattr(table, f.name), torch.Tensor)}


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
