"""Port vs JAX package: scenes, cameras and the port's isolation rules.

The port (wc_path_tracer_tpu_torch) must build the same padded scene as the
JAX package, leaf by leaf and bit for bit, and must never import JAX or the
JAX package.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import wc_path_tracer_tpu.models.builtin as jbuiltin
import wc_path_tracer_tpu.models.gltf as jgltf
import wc_path_tracer_tpu.models.obj as jobj
import wc_path_tracer_tpu.models.procedural as jproc
from wc_path_tracer_tpu.scene import camera as jcamera

from wc_path_tracer_tpu_torch.models import builtin, gltf, obj, procedural
from wc_path_tracer_tpu_torch.scene import camera, types

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_leaves(scene):
    """A JAX package Scene as {"<group>.<field>": np.ndarray}."""
    out = {}
    for group in ("materials", "spheres", "mesh"):
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            if f.name != "max_leaf_tris":
                out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def torch_leaves(scene):
    return {name: getattr(getattr(scene, name.split(".")[0]),
                          name.split(".")[1]).numpy()
            for name in types.leaf_names()}


def assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


SCENES = {
    "cornell": (lambda: jbuiltin.cornell_box_scene(),
                lambda: builtin.cornell_box_scene(device="cpu")),
    "bunny_like2": (lambda: jproc.bunny_like_scene(2),
                    lambda: procedural.bunny_like_scene(2, device="cpu")),
    "bunny_gltf": (lambda: jproc.bunny_gltf_scene(),
                   lambda: procedural.bunny_gltf_scene(device="cpu")),
    "default": (lambda: (jbuiltin.default_scene(), jbuiltin.default_camera()),
                lambda: (builtin.default_scene(device="cpu"),
                         builtin.default_camera(device="cpu"))),
    "default_true_dielectric": (
        lambda: (jbuiltin.default_scene(true_dielectric=True),
                 jbuiltin.default_camera()),
        lambda: (builtin.default_scene(true_dielectric=True, device="cpu"),
                 builtin.default_camera(device="cpu"))),
    "single_triangle": (lambda: jbuiltin.single_triangle_scene(),
                        lambda: builtin.single_triangle_scene(device="cpu")),
    "full_bsdf": (lambda: jbuiltin.full_bsdf_scene(),
                  lambda: builtin.full_bsdf_scene(device="cpu")),
    "gltf_scene": (lambda: jgltf.gltf_scene(procedural.BUNNY_GLB),
                   lambda: gltf.gltf_scene(procedural.BUNNY_GLB,
                                           device="cpu")),
}

# a quad, a pentagon (fan-triangulated) and a triangle with missing
# attribute indices, over shared and out-of-range vertex triples
OBJ_TEXT = """# test mesh
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.2
vt 0 0
vt 1 0
vn 0 0 1
f 1/1/1 2/2/1 3//1 4//1
f 1 2 3 4 5
f 2//1 3/2 9/9/9
"""


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_leaves_bit_exact(name):
    make_jax, make_torch = SCENES[name]
    jscene, jcam = make_jax()
    tscene, tcam = make_torch()
    want = jax_leaves(jscene)
    assert_leaves_equal(torch_leaves(tscene), want)
    assert tscene.mesh.max_leaf_tris == jscene.mesh.max_leaf_tris
    # the bridge: the JAX scene's leaves carried into the port unchanged
    bridged = types.scene_from_numpy(want, jscene.mesh.max_leaf_tris, "cpu")
    assert_leaves_equal(torch_leaves(bridged), want)
    for f in ("position", "yaw", "pitch", "fov"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))


def test_obj_parser_matches_jax(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    for got, want in ((obj.parse_obj(OBJ_TEXT, from_text=True),
                       jobj.parse_obj(OBJ_TEXT, from_text=True)),
                      (obj.load_obj(str(path)), jobj.parse_obj(str(path)))):
        for f in ("vertices", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
    assert len(got.indices) == 3 * (2 + 3 + 1)


def test_obj_scenes_match_jax(tmp_path):
    """default_scene with an OBJ mesh and mesh_scene, leaf for leaf."""
    path = str(tmp_path / "mesh.obj")
    (tmp_path / "mesh.obj").write_text(OBJ_TEXT)
    js = jbuiltin.default_scene(mesh_path=path)
    ts = builtin.default_scene(mesh_path=path, device="cpu")
    assert_leaves_equal(torch_leaves(ts), jax_leaves(js))
    (js, jcam), (ts, tcam) = (jbuiltin.mesh_scene(path, scale=2.0),
                              builtin.mesh_scene(path, scale=2.0,
                                                 device="cpu"))
    assert_leaves_equal(torch_leaves(ts), jax_leaves(js))
    for f in ("position", "yaw", "pitch", "fov"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))


def test_scene_to_device_keeps_every_leaf():
    scene, _ = builtin.cornell_box_scene(device="cpu")
    moved = scene.to("cpu")
    assert moved is not scene and moved.device == torch.device("cpu")
    assert_leaves_equal(torch_leaves(moved), torch_leaves(scene))
    assert moved.mesh.max_leaf_tris == scene.mesh.max_leaf_tris


def test_scene_from_numpy_rejects_missing_leaves():
    jscene, _ = jbuiltin.cornell_box_scene()
    leaves = jax_leaves(jscene)
    del leaves["mesh.vertices"]
    with pytest.raises(ValueError, match="mesh.vertices"):
        types.scene_from_numpy(leaves, 2, "cpu")


@pytest.mark.parametrize("name", ["cornell", "bunny_gltf"])
def test_camera_matrices_and_primary_rays(name):
    make_jax, make_torch = SCENES[name]
    _, jcam = make_jax()
    _, tcam = make_torch()
    jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.camera_matrices(tcam, 1.0)
    # LAPACK (torch) and XLA invert the 4x4s with different roundoff;
    # near-zero entries need the small absolute floor
    for f in ("inverse_projection", "inverse_view", "position"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    # directions from identical matrices: XLA-CPU may contract FMAs where
    # torch rounds every product, hence rtol 1e-6 rather than equality
    same = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                      np.asarray(jm.inverse_view),
                                      np.asarray(jm.position), "cpu")
    jitter = np.random.default_rng(0).random((24, 40, 2), np.float32)
    for jit in (None, jitter):
        want = jcamera.primary_ray_directions(jm, 40, 24, jitter=jit)
        got = camera.primary_ray_directions(
            same, 40, 24, None if jit is None else torch.from_numpy(jit))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def _port_files():
    files = sorted((REPO / "wc_path_tracer_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "wc_path_tracer_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert len(_port_files()) > 10
    assert not bad, bad


@pytest.mark.parametrize("entry", [
    lambda: builtin.cornell_box_scene(),
    lambda: procedural.bunny_like_scene(1),
    lambda: types.SceneBuilder().build(),
    lambda: builtin.default_scene(),
    lambda: builtin.default_camera(),
    lambda: builtin.full_bsdf_scene(),
    lambda: camera.Camera.create(),
    lambda: camera.matrices_from_numpy(np.eye(4), np.eye(4), np.zeros(3)),
])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
