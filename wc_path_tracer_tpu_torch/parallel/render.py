"""Data-parallel rendering and training over a process group (port of the
JAX package's parallel/render.py).

Rays are the data axis: the image's rows are split into one band per rank
and the scene is replicated, so a forward render needs no communication
until the bands are gathered.  Pixel seeds come from *global* pixel indices
(``golden.render_rows``), so a band equals the same rows of a
single-process frame.  The only collective of training is the sum of the
grads (and of the loss) over the ranks, after each rank's backward.

The one grad-scaling convention of the JAX package: loss and grads are
those of the MEAN squared error over the global pixels, each rank's sum
divided by the global pixel count inside the differentiated scope.  A
``group`` of None is this process alone, and the single-process
``scene_loss_grad`` is that case of ``sharded_scene_loss_grad``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.scene.camera import Camera, camera_matrices
from wc_path_tracer_tpu_torch.utils.config import RenderConfig

BENCH_TRAINABLE = ("albedo", "emission", "emission_strength", "roughness")


def _band(cfg: RenderConfig, world: int) -> int:
    if cfg.height % world:
        raise ValueError(
            f"height {cfg.height} not divisible by the world size {world}; "
            "pad the image or choose a divisible height")
    return cfg.height // world


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group``, in place."""
    dist.all_reduce(t, group=group)
    return t


def gather_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's band of rows (the same shape on each), stacked in rank
    order, on every rank."""
    if group is None:
        return rows
    rows = rows.contiguous()
    out = rows.new_empty((pmesh.world_size(group) * rows.shape[0],)
                         + tuple(rows.shape[1:]))
    dist.all_gather_into_tensor(out, rows, group=group)
    return out


def _intersect_fn(renderer, scene, cfg):
    """``renderer`` is any name dispatch.get_render_frame takes, or a
    function (scene, cfg) -> intersect_fn (e.g. the sweep through the plain
    twin)."""
    return renderer(scene, cfg) if callable(renderer) \
        else dispatch.get_intersect_fn(renderer, scene, cfg)


def _loss_rows(scene, mats, cfg: RenderConfig, frame_count: int, y0: int,
               band: int, target_rows, renderer="golden"):
    """Sum of squared errors of rows [y0, y0 + band) against
    ``target_rows``; the caller divides by the global pixel count."""
    img = golden.render_rows(scene, mats, cfg, frame_count, y0, band,
                             _intersect_fn(renderer, scene, cfg))
    return torch.sum((img - target_rows) ** 2)


def sharded_render_frame(cfg: RenderConfig, renderer="golden", group=None):
    """(scene, mats, frame_count) -> the full (H, W, 3) frame on every rank
    of ``group``: each rank renders its band of H / world rows through
    ``renderer`` (as ``_intersect_fn``), then the bands are gathered."""
    band = _band(cfg, pmesh.world_size(group))
    y0 = pmesh.rank(group) * band

    @torch.no_grad()
    def render(scene, mats, frame_count):
        rows = golden.render_rows(scene, mats, cfg, frame_count, y0, band,
                                  _intersect_fn(renderer, scene, cfg))
        return gather_rows(rows, group)

    return render


def render_image_sharded(scene, mats, cfg: RenderConfig, frame_count: int,
                         group=None):
    """Build and call the sharded brute-force render: the full (H, W, 3)
    frame on every rank of ``group``."""
    return sharded_render_frame(cfg, "golden", group)(scene, mats,
                                                      frame_count)


def sharded_scene_loss_grad(cfg: RenderConfig, trainable,
                            renderer="golden", group=None):
    """(scene, camera, frame_count, target) -> (loss, grads) over ``group``
    for any registered trainable set (optim/params.py); ``grads`` is keyed
    by trainable name, ``target`` is the full (H, W, 3) image.

    Each rank renders its band, takes its sum of squared errors divided by
    the global pixel count, runs the backward, then the flattened grads
    and the loss are each summed over the ranks by one ``all_reduce``: every
    rank returns the full image's mean loss and its grads.  ``camera`` is a
    Camera (its matrices are rebuilt differentiably inside the loss, so
    camera parameters train too) or prebuilt CameraMatrices.  The trainable
    tensors of ``scene``/``camera`` are not changed; the grads are taken
    with respect to detached copies of them."""
    trainable = reg.validate(trainable)
    band = _band(cfg, pmesh.world_size(group))
    y0 = pmesh.rank(group) * band
    npix = cfg.height * cfg.width * 3
    aspect = cfg.width / cfg.height

    def loss_grad(scene, camera, frame_count, target):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in reg.get_params(scene, camera,
                                             trainable).items()}
        s, cam = reg.apply_params(scene, camera, params)
        mats = camera_matrices(cam, aspect) if isinstance(cam, Camera) \
            else cam
        loss = _loss_rows(s, mats, cfg, frame_count, y0, band,
                          target[y0:y0 + band], renderer) / npix
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), torch.autograd.grad(
                     loss, list(params.values()), allow_unused=True))]
        loss = loss.detach()
        if group is not None:
            flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               group)
            grads = [g.view_as(p) for g, p in zip(
                flat.split([p.numel() for p in grads]), grads)]
            loss = _all_reduce(loss.reshape(1), group)[0]
        return loss, dict(zip(params, grads))

    return loss_grad


def scene_loss_grad(cfg: RenderConfig, trainable, renderer="golden"):
    """The single-process loss and grads: ``sharded_scene_loss_grad`` of
    this process alone (the whole frame as one band)."""
    return sharded_scene_loss_grad(cfg, trainable, renderer)


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
                    renderer="golden", group=None):
    """One inverse-rendering step over ``group``: render the rank's band,
    backward, grads summed over the ranks, then the optimizer update and
    range projection on every rank from the same grads, so the parameters
    stay replicated.  Returns step(scene, camera, state, frame_count,
    target) -> (scene, camera, state, loss); ``state`` is None on the first
    call (the step then builds it with ``init_train_state``) and the
    returned one after.  The returned scene and camera carry the updated
    parameters.  Grads are mean-scaled (``scene_loss_grad``)."""
    trainable = reg.validate(trainable)
    loss_grad = sharded_scene_loss_grad(cfg, trainable, renderer, group)

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
