"""Port vs JAX package: the native C++ scene pipeline (scene/native.py).

The port builds its own copy of the C++ source with g++ (kernels/build.py,
``-ffp-contract=off``, no ``-march=native``), so its trees must equal the
NumPy builder's and the JAX package's bit for bit, on every array; its OBJ
parse must equal the Python parser's.  The JAX package's counterparts are
tests/test_native.py's, held here to exact equality.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import wc_path_tracer_tpu.models.obj as jobj
import wc_path_tracer_tpu.models.procedural as jproc
from wc_path_tracer_tpu.scene import bvh as jbvh

from wc_path_tracer_tpu_torch.cli import main
from wc_path_tracer_tpu_torch.kernels import build
from wc_path_tracer_tpu_torch.models import obj, procedural
from wc_path_tracer_tpu_torch.models.gltf import parse_gltf
from wc_path_tracer_tpu_torch.scene import bvh, native, types

from tests.test_torch_scene import assert_leaves_equal, jax_leaves, torch_leaves

torch.set_num_threads(2)

BVH_ARRAYS = ("node_min", "node_max", "node_left", "node_count", "indices",
              "tri_order")
OBJ_FIELDS = ("vertices", "normals", "uvs", "indices")


def random_mesh(n_tris=300, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_tris * 3, 3)).astype(np.float32)
    idx = np.arange(n_tris * 3, dtype=np.int32)
    return v, idx


def assert_trees_equal(got, want):
    for k in BVH_ARRAYS:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def assert_obj_equal(got, want):
    for f in OBJ_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_native_library_builds_here():
    """g++ is present, so the port builds its library and records it."""
    assert native.available()
    assert native.status().startswith("native (libscene_native-")
    assert native.library_path().exists()
    b = types.SceneBuilder()
    b.add_mesh(*random_mesh(10))
    assert b.bvh_builders == ["native"]


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_bvh_native_equals_numpy_and_jax(robust, seed):
    v, idx = random_mesh(seed=seed)
    got = native.build_bvh_native(v, idx, robust=robust)
    assert_trees_equal(got, bvh.build_bvh(v, idx, robust=robust))
    assert_trees_equal(got, jbvh.build_bvh(v, idx, robust=robust))


def test_bvh_native_rejects_bad_indices():
    """The C builder reads vertices by index unchecked: the binding refuses
    an index outside the vertex table and a partial triangle."""
    v, idx = random_mesh(4)
    for bad in (idx[:-1], np.where(idx == 5, 12, idx),
                np.where(idx == 5, -1, idx)):
        with pytest.raises(ValueError):
            native.build_bvh_native(v, bad)


def test_bvh_native_degenerate_leaf():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.tile(np.array([0, 1, 2], np.int32), 10)
    b = native.build_bvh_native(v, idx, robust=False)
    assert b.num_nodes == 1 and b.node_count[0] == 30
    br = native.build_bvh_native(v, idx, robust=True)
    assert br.node_count.max() <= 6
    for robust, tree in ((False, b), (True, br)):
        assert_trees_equal(tree, bvh.build_bvh(v, idx, robust=robust))


OBJ_TEXT = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/1/1
f 1 2 3
"""


def test_obj_native_equals_python_and_jax():
    got = native.parse_obj_native(OBJ_TEXT, from_text=True)
    assert_obj_equal(got, obj.parse_obj(OBJ_TEXT, from_text=True))
    assert_obj_equal(got, jobj.parse_obj(OBJ_TEXT, from_text=True))
    assert len(got.indices) == 3 * (2 + 1)


def test_obj_native_large_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    V = 500
    lines = [f"v {x} {y} {z}" for x, y, z in rng.normal(size=(V, 3))]
    for _ in range(800):
        a, b, c = rng.integers(1, V + 1, 3)
        lines.append(f"f {a} {b} {c}")
    path = tmp_path / "big.obj"
    path.write_text("\n".join(lines))
    got = obj.load_obj(str(path))
    assert_obj_equal(got, native.parse_obj_native(str(path)))
    assert_obj_equal(got, obj.parse_obj(str(path)))
    assert_obj_equal(got, jobj.parse_obj(str(path)))
    assert len(got.indices) == 3 * 800


def test_native_faster_on_big_mesh():
    v, idx = procedural.icosphere(5)                       # 20,480 tris
    t0 = time.perf_counter()
    nb = native.build_bvh_native(v, idx, robust=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb = bvh.build_bvh(v, idx, robust=True)
    t_numpy = time.perf_counter() - t0
    assert_trees_equal(nb, pb)
    assert t_native < t_numpy, (t_native, t_numpy)


def bunny_builder(prebuilt):
    """The glTF bunny's SceneBuilder, its BVH built by add_mesh or, with
    ``prebuilt``, by the NumPy builder and passed positionally as ``bvh`` in
    the JAX package's position."""
    model = parse_gltf(procedural.BUNNY_GLB)
    b = types.SceneBuilder()
    body = b.add_material(types.MATERIAL_LAMBERTIAN,
                          albedo=model.materials[model.meshes[0].material]
                          ["albedo"])
    ground = b.add_material(types.MATERIAL_METAL, albedo=(0.6, 0.6, 0.6),
                            roughness=0.9)
    for m in model.meshes:
        tree = bvh.build_bvh(m.vertices, m.indices, robust=True) \
            if prebuilt else None
        b.add_mesh(m.vertices, m.indices, m.normals, m.uvs, body, tree)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    return b


def test_bunny_scene_native_equals_prebuilt_numpy_and_jax():
    nat, given = bunny_builder(False), bunny_builder(True)
    assert nat.bvh_builders == ["native"] and given.bvh_builders == ["given"]
    got = torch_leaves(nat.build("cpu"))
    assert_leaves_equal(got, torch_leaves(given.build("cpu")))
    jscene, _ = jproc.bunny_gltf_scene()      # the JAX native builder
    assert_leaves_equal(got, jax_leaves(jscene))
    assert procedural.bunny_gltf_scene(device="cpu")[0].mesh.max_leaf_tris \
        == jscene.mesh.max_leaf_tris


def test_split_chunks_go_through_the_native_builder():
    b = types.SceneBuilder()
    v, idx = procedural.bumpy_sphere(2)                    # 320 tris
    assert b.add_mesh(v, idx, max_blas_tris=100) == 0
    assert b.bvh_builders == ["native"] * 4
    js, _ = jproc.bunny_like_scene(2, max_blas_tris=100)
    ts, _ = procedural.bunny_like_scene(2, max_blas_tris=100, device="cpu")
    assert_leaves_equal(torch_leaves(ts), jax_leaves(js))


def test_fallback_is_visible(monkeypatch):
    """Without the library both functions give their plain versions'
    results, with one warning, and every record says NumPy built the BVH."""
    def refuse(name, src=None, signatures=None):
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(build, "load", refuse)
    v, idx = random_mesh(40, seed=5)
    with pytest.warns(RuntimeWarning, match="native scene library is "
                      "unavailable.*g\\+\\+ not found"):
        tree = native.build_bvh_native(v, idx, robust=True)
    assert_trees_equal(tree, bvh.build_bvh(v, idx, robust=True))
    assert not native.available()
    assert native.status().startswith("numpy (native library unavailable: "
                                      "RuntimeError: g++ not found")
    assert_obj_equal(native.parse_obj_native(OBJ_TEXT, from_text=True),
                     obj.parse_obj(OBJ_TEXT, from_text=True))
    b = types.SceneBuilder()
    b.add_mesh(v, idx)
    assert b.bvh_builders == ["numpy"]


def test_info_prints_the_builder(capsys):
    main(["info", "--device", "cpu"])
    assert f"bvh builder: {native.status()}" in capsys.readouterr().out


def test_library_name_hashes_the_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == build.BUILD_DIR
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ["-g"])
    assert native.library_path() != path


BUILD_ONE = """
import sys
from pathlib import Path
from wc_path_tracer_tpu_torch.kernels import build
from wc_path_tracer_tpu_torch.scene import native
build.BUILD_DIR = Path(sys.argv[1])
assert native.available(), native.status()
print(native.library_path())
"""


def test_concurrent_first_builds(tmp_path):
    """Three processes building the library at once into an empty
    directory each load a whole library and leave no temporary file."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert not [n for n in names if n.endswith(".tmp")], names
    assert any(n.endswith(".so") for n in names)
