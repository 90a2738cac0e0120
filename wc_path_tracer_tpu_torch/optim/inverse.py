"""Inverse rendering: optimize scene parameters from target images, on one
process or over a process group (port of the JAX package's
optim/inverse.py).

Built on render/golden.py's differentiable transport, optim/params.py's
trainable registry and parallel/render.py's train step: ``torch.optim.Adam``
with the registry's range projection after each step.  Checkpoint/resume:
(params, Adam state, step) are written to a directory every
``checkpoint_every`` steps in the JAX package's layout, with the Adam state
under optax's leaf names (``opt_state/0/count``, ``opt_state/0/mu/<name>``,
``opt_state/0/nu/<name>``), so a run the JAX package checkpointed resumes
here; ``resume=True`` continues the same trajectory (the PRNG frame is the
step index, so the stochastic gradients repeat).  Over a group, every
rank runs the same steps on the same summed grads; rank 0 alone writes the
checkpoints and every rank resumes from them.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from wc_path_tracer_tpu_torch.utils.config import RenderConfig

project_params = reg.project_params


@dataclasses.dataclass
class InverseRenderConfig:
    trainable: Sequence[str] = ("albedo", "emission_strength", "roughness")
    learning_rate: float = 5e-2
    steps: int = 200
    vary_seed: bool = True      # new PRNG frame per step (stochastic grads)
    log_every: int = 10


def run_inverse_rendering(scene, camera, target, render_cfg: RenderConfig,
                          inv_cfg: Optional[InverseRenderConfig] = None, *,
                          renderer: str = "golden", group=None,
                          log_fn: Optional[Callable] = None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 0,
                          resume: bool = False):
    """Optimize ``inv_cfg.trainable`` of (scene, camera) so renders match
    ``target`` (H, W, 3), through the backend ``renderer`` names (any name
    dispatch.get_render_frame takes), over the process group ``group``
    (None: this process alone; parallel/mesh.py).

    ``camera`` is a Camera (required for camera_* trainables; the matrices
    are rebuilt differentiably each step) or prebuilt CameraMatrices.
    Returns (optimized scene, optimized camera, history); history holds a
    dict (step, loss, grad_norm, wall_s) per logged step; step, loss and
    grad_norm are the same on every rank, wall_s is the rank's own clock.
    """
    inv_cfg = inv_cfg or InverseRenderConfig()
    trainable = reg.validate(inv_cfg.trainable)
    adam = functools.partial(torch.optim.Adam, lr=inv_cfg.learning_rate)
    step_fn = prender.make_train_step(render_cfg, adam, trainable, renderer,
                                      group)
    state = prender.init_train_state(scene, camera, trainable, adam)
    start_step = 0
    if resume:
        if not checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        start_step = load_training_state(checkpoint_dir, state.params,
                                         state.optimizer)

    history = []
    t_start = time.perf_counter()
    for step in range(start_step, inv_cfg.steps):
        frame = step if inv_cfg.vary_seed else 0
        scene, camera, state, loss = step_fn(scene, camera, state, frame,
                                             target)
        if step % inv_cfg.log_every == 0 or step == inv_cfg.steps - 1:
            gn = float(torch.sqrt(sum(torch.sum(g * g)
                                      for g in state.grads.values())))
            rec = dict(step=step, loss=float(loss), grad_norm=gn,
                       wall_s=time.perf_counter() - t_start)
            history.append(rec)
            if log_fn is not None:
                log_fn(rec)
        if (checkpoint_dir and checkpoint_every
                and (step + 1) % checkpoint_every == 0):
            _save(checkpoint_dir, state, step + 1, group)

    if checkpoint_dir:
        _save(checkpoint_dir, state, inv_cfg.steps, group)
    scene, camera = reg.apply_params(scene, camera, state.params)
    return scene, camera, history


def _save(directory, state, step: int, group):
    """Rank 0 writes the training state; the other ranks wait for it, so a
    resume on any rank reads a whole checkpoint."""
    if pmesh.rank(group) == 0:
        save_training_state(directory, state.params, state.optimizer, step)
    if group is not None:
        dist.barrier(group=group)


def _adam_tree(params: dict, optimizer: torch.optim.Adam) -> dict:
    """An Adam optimizer's state in optax.adam's tree: (ScaleByAdamState
    (count, mu, nu), EmptyState) -> {"0": {"count", "mu", "nu"}}."""
    count, mu, nu = 0, {}, {}
    for k, p in params.items():
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            mu[k], nu[k] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[k], nu[k] = torch.zeros_like(p), torch.zeros_like(p)
    return {"0": {"count": np.int32(count), "mu": mu, "nu": nu}}


def save_training_state(directory: str, params: dict,
                        optimizer: torch.optim.Adam, step: int):
    """Persist the resumable training state: the trainable params, the Adam
    moments and count, and the step index (= the PRNG frame)."""
    save_pytree(directory, {"params": params,
                            "opt_state": _adam_tree(params, optimizer)},
                extra_meta={"step": int(step)})


def load_training_state(directory: str, params: dict,
                        optimizer: torch.optim.Adam) -> int:
    """Fill ``params`` (in place) and ``optimizer``'s state from a training
    checkpoint (this package's or the JAX package's); returns its step."""
    state = load_pytree(directory, {"params": params,
                                    "opt_state": _adam_tree(params,
                                                            optimizer)})
    adam = state["opt_state"]["0"]
    count = int(adam["count"])
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(state["params"][k])
            if count:
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": adam["mu"][k].clone(),
                    "exp_avg_sq": adam["nu"][k].clone()}
            else:
                optimizer.state.pop(p, None)
    with open(os.path.join(directory, "manifest.json")) as f:
        return int(json.load(f)["extra"]["step"])
