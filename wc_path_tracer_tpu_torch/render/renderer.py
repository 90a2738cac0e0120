"""Progressive renderer with the reference editor's capabilities as an API
(port of the JAX package's render/renderer.py).

The reference is an interactive editor: fly camera, gizmo drags and
property edits mutate the scene, and any edit resets progressive
accumulation (src/editor.jai:149-152 movement, :214 gizmo, resize
src/PathTracingRenderer.jai:396).  Headless, those capabilities are
methods: every edit resets accumulation, ``step()`` renders progressive
frames, ``output()`` post-processes the accumulated image.

As in the JAX package, ``step`` advances the frame counter by exactly 1
(the reference advances it by 2 per stationary frame, quirk §2.4(7)), so
accumulation weights are the running mean 1/(n+1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import post
from wc_path_tracer_tpu_torch.ops import bloom as bl
from wc_path_tracer_tpu_torch.ops import tonemap as tm
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.scene.camera import Camera, camera_matrices
from wc_path_tracer_tpu_torch.scene.types import Scene
from wc_path_tracer_tpu_torch.utils.config import RenderConfig
from wc_path_tracer_tpu_torch.utils.device import resolve_device
from wc_path_tracer_tpu_torch.utils.profiling import stage


def _finalize(img, tonemap: str, gamma: float, bloom: bool = False,
              bloom_threshold: float = 1.0, bloom_knee: float = 0.1,
              bloom_strength: float = 1.0):
    """HDR (H, W, 3) -> uint8: optional bloom, the tonemap, the display
    gamma, then clip to [0, 1] and truncate to 0-255."""
    if bloom:
        img = img + bloom_strength * bl.bloom(img, bloom_threshold,
                                              bloom_knee)
    img = tm.apply(img, tonemap)
    if gamma != 1.0:
        img = torch.pow(torch.clamp_min(img, 0.0), 1.0 / gamma)
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def _shift_out(arr, index: int):
    """``arr`` with row ``index`` moved to the end (later rows shift down
    one slot): an ordered delete inside a fixed capacity."""
    return torch.cat([arr[:index], arr[index + 1:], arr[index:index + 1]])


class Renderer:
    """Owns (scene, camera, accumulation image, frame counter) on one
    device: the analog of PathTracingRenderer
    (src/PathTracingRenderer.jai:92-123) minus the Vulkan plumbing.

    ``device``: where the scene, camera and image live (default: the CUDA
    card, utils/device.py).  ``renderer``: the closest-hit backend, any name
    ``dispatch.get_render_frame`` takes; it is resolved from the current
    scene on every step, so a Renderer on (or grown into) a large meshed
    scene takes the cluster sweep under "auto".  ``render_fn`` replaces the
    whole step: (scene, mats, cfg, frame_count, old_image) -> new_image.
    """

    def __init__(self, scene: Scene, camera: Optional[Camera] = None,
                 cfg: Optional[RenderConfig] = None, render_fn=None,
                 renderer: str = "auto", device=None):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.camera = (camera if camera is not None
                       else Camera.create(device=self.device)).to(self.device)
        self.cfg = cfg if cfg is not None else RenderConfig()
        self.renderer = renderer
        self.frame_count = 0
        self.image = self._zeros()
        self._render_step = render_fn

    def _zeros(self):
        return torch.zeros((self.cfg.height, self.cfg.width, 3),
                           device=self.device)

    def _set_rows(self, arr, index: int, value):
        out = arr.clone()
        out[index] = torch.as_tensor(value, dtype=arr.dtype,
                                     device=self.device)
        return out

    def _count(self, like, n: int):
        return torch.tensor(n, dtype=like.dtype, device=self.device)

    # --- edits (all reset accumulation, like the reference editor) ---

    def reset_accumulation(self):
        self.frame_count = 0

    def set_camera(self, **kw):
        """Update camera fields (position/yaw/pitch/fov); resets
        accumulation (src/editor.jai:149-151)."""
        self.camera = dataclasses.replace(self.camera, **{
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for k, v in kw.items()})
        self.reset_accumulation()

    def update_material(self, index: int, **fields):
        """Edit one material's fields; resets accumulation (the reflection
        property editor, src/ui_utils.jai:46-194)."""
        mats = self.scene.materials
        upd = {k: self._set_rows(getattr(mats, k), index, v)
               for k, v in fields.items()}
        self.scene = dataclasses.replace(
            self.scene, materials=dataclasses.replace(mats, **upd))
        self.reset_accumulation()

    def update_sphere(self, index: int, **fields):
        """Move/resize/re-material a sphere; resets accumulation (the
        ImGuizmo drag, src/editor.jai:198-220)."""
        sph = self.scene.spheres
        upd = {k: self._set_rows(getattr(sph, k), index, v)
               for k, v in fields.items()}
        self.scene = dataclasses.replace(
            self.scene, spheres=dataclasses.replace(sph, **upd))
        self.reset_accumulation()

    def add_sphere(self, position, radius, material: int) -> int:
        """Append a sphere into the padded capacity, doubling the capacity
        when it is full (the reference buffer manager's resize on growth,
        src/BufferManager.jai:52-64); resets accumulation.  Returns its
        index."""
        sph = self.scene.spheres
        n = int(sph.count)
        if n >= sph.capacity:
            sph = dataclasses.replace(sph, **{
                k: torch.cat([a, torch.zeros_like(a)])
                for k, a in (("position", sph.position),
                             ("radius", sph.radius),
                             ("material", sph.material))})
        sph = dataclasses.replace(
            sph,
            position=self._set_rows(sph.position, n,
                                    np.asarray(position, np.float32)),
            radius=self._set_rows(sph.radius, n, np.float32(radius)),
            material=self._set_rows(sph.material, n, material),
            count=self._count(sph.count, n + 1))
        self.scene = dataclasses.replace(self.scene, spheres=sph)
        self.reset_accumulation()
        return n

    def remove_sphere(self, index: int):
        """Ordered delete from the object list (src/editor.jai:226-299);
        later spheres shift down one slot.  Resets accumulation."""
        sph = self.scene.spheres
        n = int(sph.count)
        if not 0 <= index < n:
            raise IndexError(f"sphere {index} not live (count={n})")
        sph = dataclasses.replace(
            sph, position=_shift_out(sph.position, index),
            radius=_shift_out(sph.radius, index),
            material=_shift_out(sph.material, index),
            count=self._count(sph.count, n - 1))
        self.scene = dataclasses.replace(self.scene, spheres=sph)
        self.reset_accumulation()

    def remove_mesh(self, index: int):
        """Delete a mesh draw command: later draw entries shift down, the
        live draw count drops by one and the per-triangle draw ids are
        remapped (the removed draw's triangles become padding, -1).  The
        vertex/index/BVH storage stays allocated but unreferenced.  Resets
        accumulation."""
        mesh = self.scene.mesh
        n = int(mesh.draw_count)
        if not 0 <= index < n:
            raise IndexError(f"mesh {index} not live (draw_count={n})")
        td = mesh.tri_draw
        td = torch.where(td == index, torch.full_like(td, -1),
                         torch.where(td > index, td - 1, td))
        mesh = dataclasses.replace(
            mesh,
            draw_vertex_offset=_shift_out(mesh.draw_vertex_offset, index),
            draw_index_offset=_shift_out(mesh.draw_index_offset, index),
            draw_node_offset=_shift_out(mesh.draw_node_offset, index),
            draw_index_count=_shift_out(mesh.draw_index_count, index),
            tri_draw=td,
            draw_count=self._count(mesh.draw_count, n - 1))
        self.scene = dataclasses.replace(self.scene, mesh=mesh)
        self.reset_accumulation()

    def set_samples(self, samples: int):
        self.cfg = self.cfg.replace(samples=samples)
        self.reset_accumulation()

    def set_max_bounces(self, max_bounces: int):
        self.cfg = self.cfg.replace(max_bounces=max_bounces)
        self.reset_accumulation()

    def resize(self, width: int, height: int):
        """Resize the render target; resets accumulation
        (src/PathTracingRenderer.jai:393-397)."""
        self.cfg = self.cfg.replace(width=width, height=height)
        self.image = self._zeros()
        self.reset_accumulation()

    # --- rendering ---

    @torch.no_grad()
    def step(self, n: int = 1) -> torch.Tensor:
        """Render n progressive frames, returning the accumulated HDR
        image."""
        for _ in range(n):
            mats = camera_matrices(self.camera,
                                   self.cfg.width / self.cfg.height)
            with stage("render_step", str(self.frame_count)):
                if self._render_step is None:
                    frame_fn = dispatch.get_render_frame(
                        self.renderer, self.scene, self.cfg)
                    self.image = golden.render_step(
                        self.scene, mats, self.cfg, self.frame_count,
                        self.image, frame_fn)
                else:
                    self.image = self._render_step(
                        self.scene, mats, self.cfg, self.frame_count,
                        self.image)
            self.frame_count += 1
        return self.image

    @torch.no_grad()
    def output(self, tonemap: Optional[str] = None,
               gamma: Optional[float] = None) -> np.ndarray:
        """Bloomed (if ``cfg.bloom``), tonemapped, gamma'd uint8 image
        (H, W, 3) on the host; tonemap and gamma default to the cfg's (the
        reference displays raw linear HDR, quirk §2.4(9)).  On the card the
        post kernels P1 make it (``kernels/post.py``), elsewhere their
        plain twin ``_finalize``: the same bits."""
        name = tonemap if tonemap is not None else self.cfg.tonemap
        g = float(gamma if gamma is not None else self.cfg.gamma)
        c = self.cfg
        args = (name, g, c.bloom, c.bloom_threshold, c.bloom_knee,
                c.bloom_strength)
        with stage("post"):
            if post.on_card(self.image):
                out = post.post_frame_kernel(self.image, *args)
            else:
                out = _finalize(self.image, *args)
        return out.cpu().numpy()

    def save_png(self, path: str, **kw):
        from wc_path_tracer_tpu_torch.io.image import write_png
        write_png(path, self.output(**kw))
