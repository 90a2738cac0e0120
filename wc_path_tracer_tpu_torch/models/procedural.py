"""Procedural and asset-backed meshed scenes (port of the JAX package's
models/procedural.py): the icosphere family and the committed glTF bunny
(``assets/bunny.glb``, 20,480 triangles), each over a metal ground sphere
under the gradient sky."""

from __future__ import annotations

import os

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import cluster
from wc_path_tracer_tpu_torch.models.gltf import parse_gltf
from wc_path_tracer_tpu_torch.scene.camera import Camera
from wc_path_tracer_tpu_torch.scene.types import (
    MATERIAL_LAMBERTIAN, MATERIAL_METAL, SceneBuilder)
from wc_path_tracer_tpu_torch.utils.device import resolve_device

BUNNY_GLB = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "assets", "bunny.glb"))


def icosphere(subdivisions: int = 4, radius: float = 1.0):
    """Subdivided icosahedron: 20 * 4^n triangles.

    Returns (vertices (V,3) f32, indices (I,) i32).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edge_mid: dict = {}
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    return (verts * radius).astype(np.float32), faces.reshape(-1).astype(np.int32)


def bumpy_sphere(subdivisions: int = 4, radius: float = 1.0,
                 bump_amp: float = 0.15, bump_freq: float = 5.0):
    """Icosphere with deterministic sinusoidal displacement — a "bunny-like"
    non-convex stress mesh."""
    v, idx = icosphere(subdivisions, 1.0)
    r = 1.0 + bump_amp * (
        np.sin(bump_freq * v[:, 0]) * np.sin(bump_freq * v[:, 1])
        + 0.5 * np.cos(bump_freq * 1.7 * v[:, 2]))
    return (v * (radius * r[:, None])).astype(np.float32), idx


def _bunny_camera(device):
    return Camera.create(position=(0.0, 1.3, 3.2), yaw=-90.0, pitch=-5.0,
                         fov=55.0, device=device)


def bunny_gltf_scene(max_blas_tris=None, device=None):
    """The committed glTF bunny (20,480 triangles) over the metal ground
    sphere — the meshed scene the JAX package's bench renders.
    Returns (Scene, Camera)."""
    dev = resolve_device(device)
    model = parse_gltf(BUNNY_GLB)
    b = SceneBuilder()
    gm = model.materials[model.meshes[0].material]
    body = b.add_material(MATERIAL_LAMBERTIAN, albedo=gm["albedo"])
    ground = b.add_material(MATERIAL_METAL, albedo=(0.6, 0.6, 0.6),
                            roughness=0.9)
    for mesh in model.meshes:
        b.add_mesh(mesh.vertices, mesh.indices, normals=mesh.normals,
                   uvs=mesh.uvs, tri_material=body,
                   max_blas_tris=max_blas_tris)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    return b.build(dev), _bunny_camera(dev)


def _query(o, d, t_init, coords, mat, live, clusters, variant, dev):
    """(origin, direction, t_init) + the cluster tables of ``variant``: "mt"
    (tris, cmin, cmax) or "mxu" (trisW, cmin, cmax, mat_tbl); or, for
    "bank", + (mesh,): a one-draw mesh bank of the live slots' triangles in
    slot order, with its BVH (for the BVH walks)."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    if variant == "bank":
        b = SceneBuilder()
        for m in range(int(mat.max()) + 1):
            b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
        verts = np.stack([x[live] for x in coords], 1).reshape(-1, 3)
        b.add_mesh(verts, np.arange(verts.shape[0], dtype=np.int32),
                   tri_material=mat[live])
        return (f32(o), f32(d), f32(t_init), b.build(dev).mesh)
    make = {"mt": cluster.tables_from_coords,
            "mxu": cluster.mxu_tables_from_coords}[variant]
    tables = make(*(f32(x) for x in coords), f32(mat),
                  torch.tensor(live, device=dev), clusters)
    return (f32(o), f32(d), f32(t_init)) + tables


def tie_heavy_query(n_rays: int = 4096, clusters: int = 12, seed: int = 0,
                    device=None, variant: str = "mt"):
    """A seeded closest-hit query built to tie -> (origin, direction, t_init)
    + the tables of ``variant`` ("mt": tris, cmin, cmax; "mxu": trisW, cmin,
    cmax, mat_tbl, built from the same coordinates) for
    ``kernels.cluster.cluster_sweep``; "bank": a mesh bank of the same
    triangles for the BVH walks (``kernels.traversal``).

    48 base triangles (tilted quads' halves facing +z), rising in x and z, fill
    ``clusters`` clusters of 128 slots: each cluster draws from a window of
    24 of them (windows overlapping, sliding along x, in shuffled cluster
    order), and every slot is a copy of one of those, so a hit ties exactly
    with copies at other lanes of its cluster and in neighbouring clusters,
    the first visited not always the lowest.  Origins are sorted by x, so
    ray blocks are coherent strips, and the first quarter of the rays get a
    finite search bound, so their blocks stop early.  Each slot has its own material
    id; the last cluster's last 16 slots are dead.  Vertices and origins lie
    on a 1/8 grid and direction components are powers of two, so every
    product and sum of the test except those with 1/det is exact and the
    hits do not depend on FMA contraction.
    """
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    K, T = 48, cluster.CLUSTER_TRIS
    a = np.concatenate([np.sort(r.integers(-16, 9, K))[:, None],
                        r.integers(-16, 9, (K, 1)),
                        np.arange(K)[:, None] // 3 - 8], axis=1) / 8.0
    b = a + np.stack([r.integers(4, 13, K), np.zeros(K),
                      r.integers(-2, 3, K)], axis=1) / 8.0
    c = a + np.stack([np.zeros(K), r.integers(4, 13, K),
                      r.integers(-2, 3, K)], axis=1) / 8.0
    starts = r.permutation(np.linspace(0, K - 24, clusters).astype(int))
    pick = np.concatenate([s + r.integers(0, 24, T) for s in starts])
    live = np.ones(clusters * T, bool)
    live[-16:] = False
    coords = [np.where(live[:, None], x[pick], 0.0) for x in (a, b, c)]
    mat = np.arange(clusters * T) % 97
    xy = r.integers(-16, 17, (n_rays, 2))
    xy = xy[np.lexsort((xy[:, 1], xy[:, 0]))]          # coherent ray blocks
    o = np.concatenate([xy / 8.0, np.full((n_rays, 1), 4.0)], axis=1)
    d = np.concatenate([r.choice([-1.0, 1.0], (n_rays, 2))
                        * 2.0 ** -r.integers(1, 6, (n_rays, 2)),
                        np.full((n_rays, 1), -1.0)], axis=1)
    t_init = np.full(n_rays, cluster.KINF)
    q = n_rays // 4
    t_init[:q] = r.integers(24, 33, q) / 8.0
    return _query(o, d, t_init, coords, mat, live, clusters, variant, dev)


def signed_zero_query(n_rays: int = 4096, clusters: int = 8, seed: int = 0,
                      device=None, variant: str = "mxu"):
    """A seeded closest-hit query whose tests pass through exact zeros ->
    (origin, direction, t_init) + the tables of ``variant`` (as
    ``tie_heavy_query``).

    Every triangle is a right triangle in an axis plane (x, y or z = c),
    its legs along the other two axes, with vertices on a 1/8 grid and
    legs of +-1/4, 1/2 or 1 (so normals of both signs); the plane-form
    fields n, d0, au, bu, av, bv are then dyadic and mostly zero.  Ray
    origins lie on a 1/16 grid, so many lie in a triangle's plane (P = 0),
    and each direction has one component +-1 and the others drawn from
    {0, 0, +-1/4, +-1/2}, so rays run parallel to planes (Q = 0) and along
    the u and v axes (Bu or Bv = 0); hits on edges give u, v or u + v of
    exactly 0 or 1, and coplanar copies give exact t-ties.  Origins are
    sorted so ray blocks are coherent; the first quarter of the rays get a
    finite search bound.  The last cluster's last 16 slots are dead.
    """
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    T = clusters * cluster.CLUSTER_TRIS
    axis = r.integers(0, 3, T)
    a = r.integers(-8, 9, (T, 3)) / 8.0
    legs = r.choice([-1.0, -0.5, -0.25, 0.25, 0.5, 1.0], (T, 2))
    eye = np.eye(3)
    e_u, e_v = eye[(axis + 1) % 3], eye[(axis + 2) % 3]
    b = a + legs[:, :1] * e_u
    c = a + legs[:, 1:] * e_v
    live = np.ones(T, bool)
    live[-16:] = False
    coords = [np.where(live[:, None], x, 0.0) for x in (a, b, c)]
    mat = np.arange(T) % 89
    o = r.integers(-24, 25, (n_rays, 3)) / 16.0
    o = o[np.lexsort((o[:, 2], o[:, 1], o[:, 0]))]       # coherent ray blocks
    d = r.choice([0.0, 0.0, -0.25, 0.25, -0.5, 0.5], (n_rays, 3))
    main = r.integers(0, 3, n_rays)
    d[np.arange(n_rays), main] = r.choice([-1.0, 1.0], n_rays)
    t_init = np.full(n_rays, cluster.KINF)
    q = n_rays // 4
    t_init[:q] = r.integers(4, 17, q) / 8.0
    return _query(o, d, t_init, coords, mat, live, clusters, variant, dev)


def bunny_like_scene(subdivisions: int = 5, max_blas_tris=None, device=None):
    """Bumpy icosphere (20 * 4^subdivisions triangles) + ground, gradient
    sky.  Returns (Scene, Camera)."""
    dev = resolve_device(device)
    b = SceneBuilder()
    body = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.65, 0.6, 0.5))
    ground = b.add_material(MATERIAL_METAL, albedo=(0.6, 0.6, 0.6),
                            roughness=0.9)
    v, idx = bumpy_sphere(subdivisions)
    v[:, 1] += 1.0
    b.add_mesh(v, idx, tri_material=body, max_blas_tris=max_blas_tris)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    return b.build(dev), _bunny_camera(dev)
