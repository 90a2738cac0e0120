"""Port vs JAX package: the trainable registry, Adam with projection,
checkpoints, inverse rendering and metrics.

The registry and projection must give the JAX package's values and
errors; the Adam loop (``torch.optim.Adam`` + ``project_params``) must
follow ``optax.adam`` + ``project_params`` to rtol 1e-5 over 5 steps; a
training checkpoint the JAX package writes must resume in the port (same
files, same leaf names) and continue its loss curve.
"""

import dataclasses
import functools
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.optim import inverse as jinverse
from wc_path_tracer_tpu.optim import params as jreg
from wc_path_tracer_tpu.parallel import mesh as jmesh
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.utils import checkpoint as jcheckpoint
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.optim import inverse
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import golden
from wc_path_tracer_tpu_torch.scene import camera
from wc_path_tracer_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from wc_path_tracer_tpu_torch.utils.metrics import MetricsLogger, mrays

torch.set_num_threads(2)

CFG = dict(width=16, height=16, samples=1, max_bounces=1)


def _scenes():
    js, jcam = jbuiltin.full_bsdf_scene()
    ts, tcam = builtin.full_bsdf_scene(device="cpu")
    return js, jcam, ts, tcam


def test_registry_matches_jax():
    assert reg.ALL_PARAMS == jreg.ALL_PARAMS
    for group in ("MATERIAL_PARAMS", "GEOMETRY_PARAMS", "CAMERA_PARAMS"):
        assert getattr(reg, group) == getattr(jreg, group)
    js, jcam, ts, tcam = _scenes()
    names = tuple(reg.ALL_PARAMS)
    want = jreg.get_params(js, jcam, names)
    got = reg.get_params(ts, tcam, names)
    assert list(got) == list(want)
    for k in names:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # apply a seeded perturbation, then project, in both packages
    r = np.random.default_rng(0)
    new = {k: np.array(np.asarray(v) + r.normal(size=np.shape(v)) * 2.0,
                       np.float32) for k, v in want.items()}
    js2, jcam2 = jreg.apply_params(js, jcam, jreg.project_params(
        {k: jnp.asarray(v) for k, v in new.items()}))
    ts2, tcam2 = reg.apply_params(ts, tcam, reg.project_params(
        {k: torch.from_numpy(v) for k, v in new.items()}))
    w2, g2 = jreg.get_params(js2, jcam2, names), reg.get_params(ts2, tcam2,
                                                                names)
    for k in names:
        np.testing.assert_array_equal(g2[k].numpy(), np.asarray(w2[k]),
                                      err_msg=k)
    # the inputs are untouched
    np.testing.assert_array_equal(ts.materials.albedo.numpy(),
                                  np.asarray(js.materials.albedo))


def test_registry_errors_match_jax():
    """tests/test_geometry_grads.py::test_unknown_trainable_rejected."""
    for validate in (jreg.validate, reg.validate):
        with pytest.raises(ValueError, match="unknown trainable"):
            validate(("albedo", "nope"))
    js, jcam, ts, tcam = _scenes()
    with pytest.raises(ValueError, match="requires a scene.camera.Camera"):
        jreg.get_params(js, jcamera.camera_matrices(jcam, 1.0),
                        ("camera_yaw",))
    with pytest.raises(ValueError, match="requires a scene.camera.Camera"):
        reg.get_params(ts, camera.camera_matrices(tcam, 1.0),
                       ("camera_yaw",))


def test_param_projection():
    """tests/test_subsystems.py::test_param_projection on the port."""
    p = inverse.project_params({"albedo": torch.tensor([-0.5, 0.5, 1.5]),
                                "ior": torch.tensor([0.3]),
                                "emission_strength": torch.tensor([-2.0])})
    np.testing.assert_allclose(p["albedo"].numpy(), [0.0, 0.5, 1.0])
    assert float(p["ior"][0]) == 1.0
    assert float(p["emission_strength"][0]) == 0.0


def test_adam_with_projection_matches_optax():
    """5 steps of the port's train-step update (torch.optim.Adam, then the
    projection) against optax.adam + project_params, on seeded parameters
    and gradients; some steps push values past their ranges."""
    r = np.random.default_rng(1)
    start = {"albedo": r.uniform(0.0, 1.0, (8, 3)),
             "roughness": r.uniform(0.0, 1.0, 8),
             "ior": r.uniform(1.0, 2.0, 8),
             "camera_fov": np.array(60.0)}
    start = {k: np.asarray(v, np.float32) for k, v in start.items()}
    grads = [{k: np.array(r.normal(size=v.shape) * 10.0 ** r.uniform(-3, 1),
                          np.float32) for k, v in start.items()}
             for _ in range(5)]
    lr = 0.05

    opt = optax.adam(lr)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    adam = torch.optim.Adam(list(tp.values()), lr=lr)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = jreg.project_params(optax.apply_updates(jp, upd))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        adam.step()
        with torch.no_grad():
            for k, v in reg.project_params(tp).items():
                tp[k].copy_(v)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(tp["albedo"].min()) == 0.0 or float(tp["albedo"].max()) == 1.0


def test_checkpoint_round_trip(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.tensor(3, dtype=torch.int32),
                  "d": [np.ones(2, np.float32), torch.zeros((2, 2))]}}
    save_pytree(str(tmp_path / "p"), tree, extra_meta={"step": 7})
    template = {"a": torch.zeros(5),
                "b": {"c": torch.tensor(0, dtype=torch.int32),
                      "d": [np.zeros(2, np.float32), torch.ones((2, 2))]}}
    back = load_pytree(str(tmp_path / "p"), template)
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.int32 and int(back["b"]["c"]) == 3
    np.testing.assert_array_equal(back["b"]["d"][0], np.ones(2))
    assert torch.equal(back["b"]["d"][1], torch.zeros((2, 2)))
    manifest = json.load(open(tmp_path / "p" / "manifest.json"))
    assert manifest == {"leaves": ["a", "b/c", "b/d/0", "b/d/1"],
                        "extra": {"step": 7}}
    assert (tmp_path / "p" / "b__d__1.npy").exists()
    with pytest.raises(KeyError):
        load_pytree(str(tmp_path / "p"), {"a": torch.ones(5),
                                          "e": torch.ones(2)})
    # the JAX package reads what the port wrote
    jback = jcheckpoint.load_pytree(
        str(tmp_path / "p"), {"a": jnp.zeros(5),
                              "b": {"c": jnp.int32(0),
                                    "d": [jnp.zeros(2), jnp.ones((2, 2))]}})
    np.testing.assert_array_equal(np.asarray(jback["a"]), np.arange(5))


def _emission_case():
    """default_scene with emission_strength at 0.3 of its truth, and the
    true 16 x 16 image: both packages, the port given the JAX matrices."""
    js, jcam = jbuiltin.default_scene(), jbuiltin.default_camera()
    ts = builtin.default_scene(device="cpu")
    jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                    np.asarray(jm.inverse_view),
                                    np.asarray(jm.position), "cpu")
    with torch.no_grad():
        target = golden.render_frame(ts, tm, RenderConfig(**CFG), 0)
    jwrong = dataclasses.replace(js, materials=dataclasses.replace(
        js.materials, emission_strength=js.materials.emission_strength * 0.3))
    twrong = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, emission_strength=ts.materials.emission_strength * 0.3))
    return jwrong, jm, twrong, tm, target


def _inv_cfg(pkg, steps):
    return pkg.InverseRenderConfig(trainable=("emission_strength", "albedo"),
                                   learning_rate=5e-2, steps=steps,
                                   vary_seed=True, log_every=1)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX package trains 6 steps on one device, checkpointing every
    3; the port resumes its step-3 checkpoint to step 6.  The port's
    checkpoint then has the JAX one's leaf names, and its loss curve
    follows the JAX package's."""
    jwrong, jm, twrong, tm, target = _emission_case()
    jtarget = jnp.asarray(target.numpy())
    run_dir, ck = tmp_path / "run", str(tmp_path / "jax")

    def keep_step_3(rec):
        # logged after step 3 ran, before its own checkpoint: the
        # directory then holds the checkpoint written after step 2
        if rec["step"] == 3:
            shutil.copytree(run_dir, ck)

    _, _, hist_j = jinverse.run_inverse_rendering(
        jwrong, jm, jtarget, JConfig(**CFG), _inv_cfg(jinverse, 6),
        mesh=jmesh.make_mesh(jax.devices()[:1]), log_fn=keep_step_3,
        checkpoint_dir=str(run_dir), checkpoint_every=3)
    assert json.load(open(f"{ck}/manifest.json"))["extra"] == {"step": 3}
    jax_leaves = json.load(open(f"{ck}/manifest.json"))["leaves"]
    assert "opt_state/0/mu/albedo" in jax_leaves

    out, _, hist = inverse.run_inverse_rendering(
        twrong, tm, target, RenderConfig(**CFG), _inv_cfg(inverse, 6),
        checkpoint_dir=ck, resume=True)
    assert [h["step"] for h in hist] == [3, 4, 5]
    full = {h["step"]: h for h in hist_j}
    for h in hist:
        np.testing.assert_allclose(h["loss"], full[h["step"]]["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(h["grad_norm"],
                                   full[h["step"]]["grad_norm"], rtol=1e-3)
    assert json.load(open(f"{ck}/manifest.json"))["leaves"] == jax_leaves
    assert json.load(open(f"{ck}/manifest.json"))["extra"] == {"step": 6}


def test_inverse_rendering_recovers_emission():
    """tests/test_subsystems.py::test_inverse_rendering_recovers_emission on
    the port: the loss falls tenfold and the emitter's strength returns
    toward its truth (1.0)."""
    scene = builtin.default_scene(device="cpu")
    mats = camera.camera_matrices(builtin.default_camera(device="cpu"), 1.0)
    with torch.no_grad():
        target = golden.render_frame(scene, mats, RenderConfig(**CFG), 0)
    wrong = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials,
        emission_strength=scene.materials.emission_strength * 0.2))
    inv = inverse.InverseRenderConfig(trainable=("emission_strength",),
                                      learning_rate=0.1, steps=40,
                                      vary_seed=False, log_every=20)
    out, _, hist = inverse.run_inverse_rendering(wrong, mats, target,
                                                 RenderConfig(**CFG), inv)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.1
    got = float(out.materials.emission_strength[2])
    assert 0.7 < got < 1.3, got
    # the scene passed in is untouched
    assert float(wrong.materials.emission_strength[2]) == pytest.approx(0.2)


@pytest.mark.parametrize("renderer", ["golden", "sweep"])
def test_resume_reproduces_loss_curve(tmp_path, renderer):
    """tests/test_geometry_grads.py::test_invert_checkpoint_resume_
    reproduces_loss_curve on the port: 6 steps straight equal 3 steps, a
    checkpoint and 3 resumed steps, with a Camera trainable too."""
    _, _, twrong, _, target = _emission_case()
    cam = builtin.default_camera(device="cpu")
    cfg = RenderConfig(**CFG)

    def inv_cfg(steps):
        return inverse.InverseRenderConfig(
            trainable=("emission_strength", "camera_position"),
            learning_rate=5e-2, steps=steps, vary_seed=True, log_every=1)

    out_a, cam_a, hist_a = inverse.run_inverse_rendering(
        twrong, cam, target, cfg, inv_cfg(6), renderer=renderer)
    ck = str(tmp_path / "ck")
    inverse.run_inverse_rendering(twrong, cam, target, cfg, inv_cfg(3),
                                  renderer=renderer, checkpoint_dir=ck,
                                  checkpoint_every=2)
    out_b, cam_b, hist_b = inverse.run_inverse_rendering(
        twrong, cam, target, cfg, inv_cfg(6), renderer=renderer,
        checkpoint_dir=ck, resume=True)
    assert hist_b[0]["step"] == 3
    full = {h["step"]: h["loss"] for h in hist_a}
    for h in hist_b:
        np.testing.assert_allclose(h["loss"], full[h["step"]], rtol=1e-5)
    np.testing.assert_allclose(out_b.materials.emission_strength.numpy(),
                               out_a.materials.emission_strength.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(cam_b.position.numpy(), cam_a.position.numpy(),
                               rtol=1e-6)
    assert not torch.equal(cam_a.position, cam.position)


def test_train_step_lowers_the_loss():
    """make_train_step with the bench's trainables on the Cornell box
    under NEE+MIS: one step lowers the loss of the same frame (the
    multi-device dry run's assertion), and every grad is finite."""
    scene, cam = builtin.cornell_box_scene(device="cpu")
    cfg = RenderConfig(width=16, height=16, samples=1, max_bounces=2,
                       sky="black", use_nee=True, mis=True)
    step = prender.make_train_step(
        cfg, functools.partial(torch.optim.Adam, lr=1e-2))
    target = torch.zeros((16, 16, 3))
    s1, c1, state, loss0 = step(scene, cam, None, 0, target)
    assert all(bool(torch.isfinite(g).all()) for g in state.grads.values())
    loss1, _ = prender.scene_loss_grad(cfg, prender.BENCH_TRAINABLE)(
        s1, c1, 0, target)
    assert float(loss1) < float(loss0)


def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path, echo=False)
    log.log("frame", frame=1, mrays_per_s=123.4)
    log.log("frame", frame=2, mrays_per_s=125.0)
    log.close()
    recs = [json.loads(line) for line in open(path)]
    assert len(recs) == 2 and recs[0]["event"] == "frame"
    assert recs[1]["mrays_per_s"] == 125.0
    assert mrays(100, 100, 2, 3, 1.0) == 100 * 100 * 2 * 4 / 1e6
