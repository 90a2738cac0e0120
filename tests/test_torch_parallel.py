"""Data-parallel rendering and training over 2 gloo processes on the CPU.

One module fixture starts 2 ranks of ``parallel/dp_check.py`` (torch only)
once; each runs the same tasks over its process group, and the test holds
their results against the same tasks computed in this process alone:

- a band render gathered from both ranks equals the single-process frame
  bit for bit (pixel seeds are global), on the brute-force path and through
  the cluster sweep;
- the sharded loss is within 1e-6 relative and every grad leaf within 1e-5
  of its max of the single-process ``scene_loss_grad``, NEE off and
  NEE+MIS (the two bands' sums reorder the single process's sums).  The
  camera position's grad is a sum of per-pixel terms that cancel (its value
  is about the size of each band's part), so the reordering moves it by
  ~1e-4 of its value.  It is held bit for bit to the sum of the two bands'
  single-process grads; in float64 that sum equals the whole frame's grad
  within 1e-5 of its max; and the ranks' grad is within 1e-2 of the
  single process's own float32 error (its float32 grad against its
  float64 one) of the single-process grad;
- an indivisible height raises ValueError; a train step over the group
  lowers the loss and leaves both ranks holding equal parameters;
  ``run_inverse_rendering`` over the group gives every rank the same
  history, checkpoints once and resumes on every rank; ``replicate_scene``
  gives every rank rank 0's scene.

The ranks run this file as a script: its ``__main__`` is ``dp_check``'s
with this file's extra task kind, ``inverse``.
"""

import dataclasses
import functools
import os


import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.optim.inverse import (InverseRenderConfig,
                                                    run_inverse_rendering)
from wc_path_tracer_tpu_torch.parallel import dp_check
from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices

torch.set_num_threads(2)

C16 = dict(width=16, height=16, samples=1, max_bounces=2, sky="black")
GEOMETRY = list(prender.BENCH_TRAINABLE) + ["sphere_position", "vertices"]
DRY_RUN = ["albedo", "emission_strength", "roughness", "sphere_position",
           "vertices", "camera_position"]


def _inverse(task, cfg, scene, cam, target, group):
    """``run_inverse_rendering`` over ``group`` for ``steps`` - 1 steps with
    checkpoints, then resumed to ``steps``."""
    ck = task["checkpoint_dir"]
    inv = functools.partial(InverseRenderConfig,
                            trainable=tuple(task["trainable"]),
                            learning_rate=task["lr"], log_every=1)
    steps = task["steps"]
    renderer = task["renderer"]
    _, _, first = run_inverse_rendering(
        scene, cam, target, cfg, inv(steps=steps - 1), renderer=renderer,
        group=group, checkpoint_dir=ck, checkpoint_every=2)
    _, _, resumed = run_inverse_rendering(
        scene, cam, target, cfg, inv(steps=steps), renderer=renderer,
        group=group, checkpoint_dir=ck, resume=True)
    return dict(history=first, resumed=resumed, files=sorted(os.listdir(ck)))


EXTRA = {"inverse": _inverse}


def _tasks(tmp):
    return [
        dict(name="render_brute", kind="render", scene="cornell", cfg=C16,
             renderer="golden", frame=1),
        dict(name="render_sweep", kind="render", scene="bunny_like2",
             cfg=dict(C16, sky="gradient"), renderer="auto", frame=1),
        dict(name="loss_grad", kind="loss_grad", scene="cornell", cfg=C16,
             trainable=list(prender.BENCH_TRAINABLE), renderer="auto"),
        dict(name="loss_grad_nee", kind="loss_grad", scene="cornell",
             cfg=dict(C16, use_nee=True), trainable=GEOMETRY,
             renderer="auto"),
        dict(name="loss_grad_camera", kind="loss_grad", scene="cornell",
             cfg=dict(C16, use_nee=True), trainable=["camera_position"],
             renderer="auto"),
        dict(name="train", kind="train", scene="cornell",
             cfg=dict(C16, use_nee=True), trainable=DRY_RUN, renderer="auto",
             lr=1e-2),
        dict(name="train_sweep", kind="train", scene="bunny_like2",
             cfg=dict(C16, sky="gradient", use_nee=True),
             trainable=["albedo", "vertices", "sphere_position"],
             renderer="auto", lr=1e-2),
        dict(name="inverse", kind="inverse", scene="cornell",
             cfg=dict(C16, use_nee=True),
             trainable=["albedo", "emission_strength"], renderer="auto",
             lr=0.05, steps=4, checkpoint_dir=str(tmp / "ck")),
        dict(name="replicate", kind="replicate", scene="cornell", cfg=C16),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the single-process results) of ``_tasks``."""
    tmp = tmp_path_factory.mktemp("dp")
    tasks = _tasks(tmp)
    ranks = dp_check.run_ranks(tasks, 2, "gloo", "cpu", str(tmp / "out"),
                               timeout=300, worker=__file__)
    single = {t["name"]: dp_check.run_task(
        dict(t, checkpoint_dir=str(tmp / "ck1")) if t["kind"] == "inverse"
        else t, "cpu", extra=EXTRA) for t in tasks}
    return ranks, single


def test_the_ranks_ran_a_gloo_group(runs):
    ranks, _ = runs
    assert [(r["rank"], r["world_size"], r["backend"]) for r in ranks] == \
        [(0, 2, "gloo"), (1, 2, "gloo")]


@pytest.mark.parametrize("name", ["render_brute", "render_sweep"])
def test_band_render_equals_single_process_frame(runs, name):
    ranks, single = runs
    want = single[name]["image"]
    assert want.shape == (16, 16, 3)
    for r in ranks:
        assert torch.equal(r[name]["image"], want), r["rank"]


@pytest.mark.parametrize("name", ["loss_grad", "loss_grad_nee"])
def test_sharded_loss_grad_matches_single_process(runs, name):
    ranks, single = runs
    want = single[name]
    for r in ranks:
        got = r[name]
        assert abs(float(got["loss"]) - float(want["loss"])) <= \
            1e-6 * abs(float(want["loss"]))
        assert list(got["grads"]) == list(want["grads"])
        for k, g in want["grads"].items():
            scale = float(g.abs().max())
            err = float((got["grads"][k] - g).abs().max())
            assert err <= 1e-5 * scale, (k, err, scale)
    for k in ("albedo", "vertices"):
        if k in want["grads"]:
            assert float(want["grads"][k].abs().max()) > 0.0, k


def _float64(x):
    """A scene or camera with every float tensor in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _float64(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _camera_grads(scene, cam, bands):
    """The camera position's grad of the bench loss of each band
    (y0, rows) of the 16 x 16 NEE+MIS frame, in the scene's dtype."""
    cfg = RenderConfig(**C16, use_nee=True)
    target = torch.zeros(16, 16, 3, dtype=cam.position.dtype)
    out = []
    for y0, rows in bands:
        p = cam.position.detach().clone().requires_grad_(True)
        s, c = reg.apply_params(scene, cam, {"camera_position": p})
        loss = prender._loss_rows(s, camera_matrices(c, 1.0), cfg, 0, y0,
                                  rows, target[y0:y0 + rows], "auto")
        out.append(torch.autograd.grad(loss / (16 * 16 * 3), p)[0])
    return out


def test_camera_grad_is_the_sum_of_the_band_grads(runs):
    ranks, single = runs
    scene, cam = builtin.cornell_box_scene(device="cpu")
    parts = _camera_grads(scene, cam, [(0, 8), (8, 8)])
    want = single["loss_grad_camera"]["grads"]["camera_position"]
    # in float64 the band split leaves the grad as it is (~1e-13 of it)...
    full64, *parts64 = _camera_grads(_float64(scene), _float64(cam),
                                     [(0, 16), (0, 8), (8, 8)])
    scale = float(full64.abs().max())
    assert float((parts64[0] + parts64[1] - full64).abs().max()) \
        <= 1e-5 * scale
    # ...and in float32 it moves the grad by far less than float32 itself
    # does (the single process's float32 grad against the float64 one)
    f32_err = float((want.double() - full64).abs().max())
    for r in ranks:
        got = r["loss_grad_camera"]["grads"]["camera_position"]
        assert torch.equal(got, parts[0] + parts[1])
        err = float((got - want).abs().max())
        assert err <= 1e-2 * f32_err, (err, f32_err)
    assert float((parts[0] + parts[1]).abs().max()) > 0.0


def test_indivisible_height_raises():
    with pytest.raises(ValueError, match="not divisible by the world size 2"):
        prender._band(RenderConfig(**dict(C16, height=15)), 2)
    with pytest.raises(ValueError, match="not divisible by the world size 3"):
        prender._band(RenderConfig(**C16), 3)


@pytest.mark.parametrize("name", ["train", "train_sweep"])
def test_train_step_lowers_loss_and_keeps_ranks_equal(runs, name):
    ranks, single = runs
    r0, r1 = (r[name] for r in ranks)
    assert float(r0["loss_after"]) < float(r0["loss_before"])
    for k, g in r0["grads"].items():
        assert torch.isfinite(g).all(), k
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    assert float(r1["loss_after"]) == float(r0["loss_after"])
    assert abs(float(r0["loss_before"]) - float(single[name]["loss_before"])
               ) <= 1e-6 * float(single[name]["loss_before"])


def test_inverse_rendering_over_the_group(runs):
    ranks, single = runs
    keys = ("step", "loss", "grad_norm")
    hist = [[{k: h[k] for k in keys} for h in r["inverse"]["history"]
             + r["inverse"]["resumed"]] for r in ranks]
    assert hist[0] == hist[1]
    assert [h["step"] for h in hist[0]] == [0, 1, 2, 3]
    want = single["inverse"]["history"] + single["inverse"]["resumed"]
    for a, b in zip(hist[0], want):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    assert ranks[0]["inverse"]["files"] == single["inverse"]["files"]


def test_replicate_scene_takes_rank_0s_tensors(runs):
    ranks, single = runs
    want = single["replicate"]["albedo"]     # rank 0 leaves its scene as is
    for r in ranks:
        assert torch.equal(r["replicate"]["albedo"], want)
        assert r["replicate"]["before_differs"] == (r["rank"] != 0)


def test_a_group_of_none_is_this_process_alone():
    assert pmesh.initialize_distributed("gloo", world_size=1) is None
    assert pmesh.initialize_distributed("gloo") is None
    assert (pmesh.rank(None), pmesh.world_size(None)) == (0, 1)
    with pytest.raises(ValueError, match="unknown backend"):
        pmesh.initialize_distributed("mpi", world_size=2)
    cfg = RenderConfig(**C16)
    scene, cam = builtin.cornell_box_scene(device="cpu")
    target = torch.zeros(16, 16, 3)
    a = prender.scene_loss_grad(cfg, ("albedo",), "auto")(scene, cam, 0,
                                                          target)
    b = prender.sharded_scene_loss_grad(cfg, ("albedo",), "auto", None)(
        scene, cam, 0, target)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1]["albedo"],
                                                   b[1]["albedo"])
    assert pmesh.replicate_scene(scene, None) is scene


if __name__ == "__main__":
    dp_check.main(extra=EXTRA)
