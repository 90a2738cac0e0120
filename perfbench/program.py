"""The system under test: the measured package's scene, camera and render
configuration, built through its public constructors from the raw scene
that the reference is handed too.  Nothing of the package is imported
before a function here runs."""

from __future__ import annotations

_MATERIAL_KEYS = ("mtype", "albedo", "emission", "emission_strength",
                  "metallic", "roughness")


def build_scene(raw: dict, device):
    """(Scene, Camera) of the program on ``device``."""
    from wc_path_tracer_tpu_torch.scene.camera import Camera
    from wc_path_tracer_tpu_torch.scene.types import SceneBuilder

    b = SceneBuilder()
    for m in raw["materials"]:
        b.add_material(**{k: m[k] for k in _MATERIAL_KEYS if k in m})
    for s in raw["spheres"]:
        b.add_sphere(tuple(s["position"]), s["radius"], s["material"])
    b.add_mesh(raw["vertices"], raw["indices"], normals=raw["normals"],
               tri_material=raw["tri_material"])
    cam = raw["camera"]
    return b.build(device), Camera.create(
        position=tuple(cam["position"]), yaw=cam["yaw"], pitch=cam["pitch"],
        fov=cam["fov"], device=device)


def render_config(render: dict, **post):
    from wc_path_tracer_tpu_torch.utils.config import RenderConfig

    return RenderConfig(**render, **post)
