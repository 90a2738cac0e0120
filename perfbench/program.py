"""The system under test: the measured package's scene, camera and render
configuration, built through its public constructors from the raw scene
that the reference is handed too.  Nothing of the package is imported
before a function here runs."""

from __future__ import annotations

# every field of SceneBuilder.add_material; one a raw material leaves out
# takes the builder's default
_MATERIAL_KEYS = ("mtype", "albedo", "emission", "emission_strength",
                  "metallic", "roughness", "absorption",
                  "absorption_strength", "ior")


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


def span_names() -> tuple:
    """The names of the program's spans (``profiling.SPANS``)."""
    from wc_path_tracer_tpu_torch.utils import profiling

    return tuple(name for name, _ in profiling.SPANS)


def counting():
    """``profiling.counting()``: the program's counters over a block; the
    dict it yields holds {counter: total} once the block exits."""
    from wc_path_tracer_tpu_torch.utils import profiling

    return profiling.counting()
