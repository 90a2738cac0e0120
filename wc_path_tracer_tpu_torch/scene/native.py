"""ctypes bindings of the native C++ scene pipeline (scene/csrc/
scene_native.cpp): the port of the JAX package's scene/native.py.

The reference builds its BVH and parses OBJ in compiled native host code
(src/PathTracingRenderer.jai:147-217, src/ModelLoader.jai:60-141); this
module is the port's equivalent.  Its results are those of the NumPy
builder (scene/bvh.py) and the Python parser (models/obj.py), which are
its plain versions: tests/test_torch_native.py holds the trees equal bit
for bit, so a large mesh's host build takes a fraction of a second.

The library is built from the checkout's source (SOURCE) with g++ on first
use (kernels/build.py: ``-O2 -fPIC -std=c++17 -ffp-contract=off -shared``
into kernels/_build/), never at import.  If it cannot be built or loaded, both
functions fall back to their plain versions, as the JAX package's do, but
not quietly: the first fallback warns, and ``available()`` / ``status()``
say which builder is in use and why (``python -m wc_path_tracer_tpu_torch
info`` prints it; ``SceneBuilder.bvh_builders`` records it per mesh).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from wc_path_tracer_tpu_torch.kernels import build
from wc_path_tracer_tpu_torch.scene.bvh import (BVH, LEAF_INDEX_COUNT,
                                                MAX_DEPTH, build_bvh)

LIBRARY = "scene_native"
SOURCE = Path(__file__).resolve().parent / "csrc" / "scene_native.cpp"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # vertices, vertex count, indices (permuted in place), index count,
    # leaf index count, max depth, robust, node min / max / left / count,
    # tri_order, node capacity -> nodes written or -1
    "wc_build_bvh": ([_P, _I, _P] + [_I] * 4 + [_P] * 5 + [_I], _I),
    # text, length -> ObjResult*
    "wc_parse_obj": ([ctypes.c_char_p, ctypes.c_int64], _P),
    "wc_obj_free": ([_P], None),
}

_lock = threading.Lock()
_lib = None
_error: str | None = None    # why the library is unavailable, once known


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("n_vertices", ctypes.c_int32),
        ("n_indices", ctypes.c_int32),
    ]


def _load():
    """The loaded library, built on first use; None (after one warning) if
    it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            _lib = build.load(LIBRARY, SOURCE, SIGNATURES)
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {str(e).strip()[:500]}"
            warnings.warn("the native scene library is unavailable "
                          f"({_error}); BVHs are built with NumPy and OBJ "
                          "files parsed in Python", RuntimeWarning,
                          stacklevel=3)
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it if
    needed)."""
    return _load() is not None


def library_path() -> Path:
    """Where the library of this checkout's source is (or will be)
    built."""
    return build.library_path(LIBRARY, SOURCE)


def status() -> str:
    """One line: the builder in use, with the library's file, or why the
    library is unavailable."""
    if available():
        return (f"native ({library_path().name}, g++ "
                f"{' '.join(build.HOST_FLAGS)})")
    return f"numpy (native library unavailable: {_error})"


def _ptr(a):
    return a.ctypes.data


def build_bvh_native(vertices: np.ndarray, indices: np.ndarray,
                     leaf_index_count: int = LEAF_INDEX_COUNT,
                     max_depth: int = MAX_DEPTH,
                     robust: bool = False) -> BVH:
    """Native BVH build -> scene.bvh.BVH, equal to ``build_bvh``'s on every
    array.  Falls back to ``build_bvh`` when the library is unavailable."""
    lib = _load()
    if lib is None:
        return build_bvh(vertices, indices, leaf_index_count, max_depth,
                         robust=robust)
    vertices = np.ascontiguousarray(vertices, np.float32).reshape(-1, 3)
    indices = np.array(indices, np.int32).reshape(-1)     # permuted in place
    if len(indices) % 3:
        raise ValueError("index count must be a multiple of 3")
    if len(indices) and (indices.min() < 0
                         or indices.max() >= len(vertices)):
        raise ValueError(f"vertex indices must lie in [0, {len(vertices)})")
    n_tris = len(indices) // 3
    cap = max(2 * n_tris, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_left = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    tri_order = np.empty(max(n_tris, 1), np.int32)
    n = lib.wc_build_bvh(
        _ptr(vertices), len(vertices), _ptr(indices), len(indices),
        leaf_index_count, max_depth, int(robust), _ptr(node_min),
        _ptr(node_max), _ptr(node_left), _ptr(node_count), _ptr(tri_order),
        cap)
    if n < 0:
        raise RuntimeError("native BVH build exceeded node capacity")
    return BVH(node_min=node_min[:n].copy(), node_max=node_max[:n].copy(),
               node_left=node_left[:n].copy(), node_count=node_count[:n].copy(),
               indices=indices, tri_order=tri_order[:n_tris].copy())


def parse_obj_native(path_or_text: str, from_text: bool = False):
    """Native OBJ parse -> models.obj.ObjModel, equal to ``parse_obj``'s.
    Falls back to ``parse_obj`` when the library is unavailable."""
    from wc_path_tracer_tpu_torch.models.obj import ObjModel, parse_obj
    lib = _load()
    if lib is None:
        return parse_obj(path_or_text, from_text)
    if from_text:
        data = path_or_text.encode()
    else:
        with open(path_or_text, "rb") as f:
            data = f.read()
    rp = ctypes.cast(lib.wc_parse_obj(data, len(data)),
                     ctypes.POINTER(_ObjResult))
    try:
        r = rp.contents
        V, I = r.n_vertices, r.n_indices

        def take(ptr, shape, dtype):
            if not shape[0]:
                return np.zeros(shape, dtype)
            return np.ctypeslib.as_array(ptr, shape).copy()

        return ObjModel(vertices=take(r.vertices, (V, 3), np.float32),
                        normals=take(r.normals, (V, 3), np.float32),
                        uvs=take(r.uvs, (V, 2), np.float32),
                        indices=take(r.indices, (I,), np.int32))
    finally:
        lib.wc_obj_free(rp)
