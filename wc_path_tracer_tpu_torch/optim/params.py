"""Trainable-parameter registry for inverse rendering (port of the JAX
package's optim/params.py).

Maps trainable names to scene and camera tensors, with the range each is
projected onto after an optimizer step (the headless analog of the
reference property editor's @Range annotations, src/ui_utils.jai:120-140).
Three families:

- material fields (``scene.materials.*``);
- geometry: sphere positions and radii, mesh vertex positions;
- camera: position, yaw, pitch, fov (0-d tensors of ``Camera``; the
  matrices are rebuilt inside the loss by ``camera_matrices``, which is
  plain differentiable torch).

Gradients for geometry flow through the differentiable re-shade of the
detached closest-hit search on every backend (brute force, the cluster
sweep's attached vertex slabs, the BVH walks' vertex gather): exact for
interior parameters.  Hit/miss boundaries carry no gradient unless
``RenderConfig.edge_grads`` is on, whose coverage estimator makes primary
silhouettes and sphere shadows continuous.
"""

from __future__ import annotations

import dataclasses

import torch

from wc_path_tracer_tpu_torch.scene.camera import Camera

# name -> (projection lo, hi)
MATERIAL_PARAMS = {
    "albedo": (0.0, 1.0),
    "emission": (0.0, None),
    "emission_strength": (0.0, None),
    "metallic": (0.0, 1.0),
    "roughness": (0.0, 1.0),
    "absorption": (0.0, None),
    "absorption_strength": (0.0, None),
    "ior": (1.0, None),
}

GEOMETRY_PARAMS = {
    "sphere_position": (None, None),
    "sphere_radius": (1e-3, None),    # radius must stay positive
    "vertices": (None, None),
}

CAMERA_PARAMS = {
    "camera_position": (None, None),
    "camera_yaw": (None, None),
    "camera_pitch": (-89.9, 89.9),    # keep look_at's up vector valid
    "camera_fov": (5.0, 175.0),
}

ALL_PARAMS = {**MATERIAL_PARAMS, **GEOMETRY_PARAMS, **CAMERA_PARAMS}


def validate(trainable) -> tuple:
    unknown = [k for k in trainable if k not in ALL_PARAMS]
    if unknown:
        raise ValueError(
            f"unknown trainable parameter(s) {unknown}; "
            f"options: {sorted(ALL_PARAMS)}")
    return tuple(trainable)


def get_params(scene, camera, trainable) -> dict:
    """The trainable tensors of (scene, camera) as a flat {name: tensor}
    dict (the scene's own tensors, not copies)."""
    out = {}
    for k in trainable:
        if k in MATERIAL_PARAMS:
            out[k] = getattr(scene.materials, k)
        elif k == "sphere_position":
            out[k] = scene.spheres.position
        elif k == "sphere_radius":
            out[k] = scene.spheres.radius
        elif k == "vertices":
            out[k] = scene.mesh.vertices
        elif k.startswith("camera_"):
            if not isinstance(camera, Camera):
                raise ValueError(
                    f"{k} requires a scene.camera.Camera, got "
                    f"{type(camera).__name__} (prebuilt matrices cannot be "
                    "optimized)")
            out[k] = getattr(camera, k[len("camera_"):])
        else:
            raise ValueError(f"unknown trainable parameter {k!r}")
    return out


def apply_params(scene, camera, params):
    """(scene, camera) with the tensors of a {name: tensor} dict in place
    of their fields (new dataclasses; the inputs are not changed)."""
    mat_kw = {k: v for k, v in params.items() if k in MATERIAL_PARAMS}
    if mat_kw:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **mat_kw))
    sph_kw = {}
    if "sphere_position" in params:
        sph_kw["position"] = params["sphere_position"]
    if "sphere_radius" in params:
        sph_kw["radius"] = params["sphere_radius"]
    if sph_kw:
        scene = dataclasses.replace(
            scene, spheres=dataclasses.replace(scene.spheres, **sph_kw))
    if "vertices" in params:
        scene = dataclasses.replace(
            scene, mesh=dataclasses.replace(scene.mesh,
                                            vertices=params["vertices"]))
    cam_kw = {k[len("camera_"):]: v for k, v in params.items()
              if k.startswith("camera_")}
    if cam_kw:
        camera = dataclasses.replace(camera, **cam_kw)
    return scene, camera


@torch.no_grad()
def project_params(params: dict) -> dict:
    """Each parameter clamped to its valid range (new tensors, no grad)."""
    out = {}
    for k, v in params.items():
        lo, hi = ALL_PARAMS.get(k, (None, None))
        if lo is not None:
            v = torch.maximum(v, torch.full_like(v, lo))
        if hi is not None:
            v = torch.minimum(v, torch.full_like(v, hi))
        out[k] = v
    return out
