"""The training loss and step on one process (port of the single-process
part of the JAX package's parallel/render.py).

The JAX package shards the image's rows over a device mesh and all-reduces
the parameter gradients; here one process renders the whole frame.  The
loss is a sum divided by the *global* pixel count, so the split over ranks
(ROADMAP A11) adds a row band per rank and an ``all_reduce`` of the grads
and changes no convention.
"""

from __future__ import annotations

import dataclasses

import torch

from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.scene.camera import Camera, camera_matrices
from wc_path_tracer_tpu_torch.utils.config import RenderConfig

BENCH_TRAINABLE = ("albedo", "emission", "emission_strength", "roughness")


def _loss_rows(scene, mats, cfg: RenderConfig, frame_count: int, target,
               renderer: str = "golden"):
    """Sum of squared errors of the frame against ``target``.  ``renderer``
    is any name dispatch.get_render_frame takes, or a function (scene, cfg)
    -> intersect_fn (e.g. the sweep through the plain twin).  The caller
    divides by the global pixel count."""
    fn = renderer(scene, cfg) if callable(renderer) \
        else dispatch.get_intersect_fn(renderer, scene, cfg)
    img = golden.render_frame(scene, mats, cfg, frame_count, intersect_fn=fn)
    return torch.sum((img - target) ** 2)


def scene_loss_grad(cfg: RenderConfig, trainable, renderer: str = "golden"):
    """(scene, camera, frame_count, target) -> (loss, grads) for any
    registered trainable set (optim/params.py); ``grads`` is keyed by
    trainable name.

    ``camera`` is a Camera (its matrices are rebuilt differentiably inside
    the loss, so camera parameters train too) or prebuilt CameraMatrices (a
    fixed camera).  The one grad-scaling convention of the JAX package:
    loss and grads are those of the MEAN squared error over the global
    pixels, normalised inside the differentiated scope.  The trainable
    tensors of ``scene``/``camera`` are not changed; the grads are taken
    with respect to detached copies of them."""
    trainable = reg.validate(trainable)
    npix = cfg.height * cfg.width * 3
    aspect = cfg.width / cfg.height

    def loss_grad(scene, camera, frame_count, target):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in reg.get_params(scene, camera,
                                             trainable).items()}
        s, cam = reg.apply_params(scene, camera, params)
        mats = camera_matrices(cam, aspect) if isinstance(cam, Camera) \
            else cam
        loss = _loss_rows(s, mats, cfg, frame_count, target, renderer) / npix
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}

    return loss_grad


@dataclasses.dataclass
class TrainState:
    """What a train step carries: the trainable leaves the optimizer
    updates, the optimizer, and the last step's grads."""

    params: dict
    optimizer: torch.optim.Optimizer
    grads: dict | None = None


def init_train_state(scene, camera, trainable, optimizer) -> TrainState:
    """``optimizer``: a factory, list of tensors -> torch.optim.Optimizer
    (e.g. ``functools.partial(torch.optim.Adam, lr=1e-2)``), applied to
    copies of the trainable tensors."""
    params = {k: v.detach().clone()
              for k, v in reg.get_params(scene, camera,
                                         reg.validate(trainable)).items()}
    return TrainState(params, optimizer(list(params.values())))


def make_train_step(cfg: RenderConfig, optimizer, trainable=BENCH_TRAINABLE,
                    renderer: str = "golden"):
    """One inverse-rendering step: render, backward, optimizer update and
    range projection.  Returns step(scene, camera, state, frame_count,
    target) -> (scene, camera, state, loss); ``state`` is None on the first
    call (the step then builds it with ``init_train_state``) and the
    returned one after.  The returned scene and camera carry the updated
    parameters.  Grads are mean-scaled (``scene_loss_grad``)."""
    trainable = reg.validate(trainable)
    loss_grad = scene_loss_grad(cfg, trainable, renderer)

    def step(scene, camera, state, frame_count, target):
        if state is None:
            state = init_train_state(scene, camera, trainable, optimizer)
        scene, camera = reg.apply_params(scene, camera, state.params)
        loss, state.grads = loss_grad(scene, camera, frame_count, target)
        for k, p in state.params.items():
            p.grad = state.grads[k]
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in reg.project_params(state.params).items():
                state.params[k].copy_(v)
        scene, camera = reg.apply_params(scene, camera, state.params)
        return scene, camera, state, loss

    return step
