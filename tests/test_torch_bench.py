"""The port's bench entry point (``python -m wc_path_tracer_tpu_torch.bench``)
against the JAX package's ``bench.py``, on the CPU at 16 x 16.

- The step: on the single triangle and the default scene, 2 bounces,
  frames 1-2, the bench's fwd+bwd step scalar (loss + the sum of every
  grad) against the JAX package's ``jax.value_and_grad`` of ``bench.py``'s
  loss (``bench.py:142-153``, rebuilt here from the package's public
  functions, since bench.py nests it in ``main``).  Tolerances: rtol 1e-5
  on the loss, rtol 1e-4 on each grad's sum and on the folded scalar.
- The alive count equals the JAX ``golden.count_alive_segments``.
- The JSON line, its keys and metric strings: the strings are read from
  ``bench.py``'s source (``bench_py_metric`` evaluates its ``"metric"``
  expressions with the run's values), never by importing it.
- The scaling row's step (C4): on the Cornell box, n = 8 band frames of
  2 rows, one batch (``golden.render_rows_frames``): its images bit for
  bit, loss and grads rtol 1e-5 against the same frames rendered one
  after another; against the JAX form ``bench.py:_scaling_at`` builds
  (``jax.vmap`` of ``golden.render_rows`` over the frames under
  ``jax.value_and_grad``, jitted) with the Cornell grad tests' tolerances,
  whose outlier bound covers the roundoff-decided paths of ROADMAP C1: at
  most 1 % of pixels off by more than 1e-3, loss rtol 1e-3, each grad leaf
  within 1e-3 of its largest |g|.  Batching refuses ``pixel_jitter`` and
  ``edge_grads``.
- A row that raises ends the run non-zero; without a card and without
  ``--device`` the bench exits non-zero; the module imports no JAX.
"""

import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.render import dispatch as jdispatch
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.scene.camera import camera_matrices as jcamera_matrices
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import bench
from wc_path_tracer_tpu_torch.kernels import launches
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import golden
from wc_path_tracer_tpu_torch.scene.camera import (camera_matrices,
                                                   matrices_from_numpy)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BOUNCES, FRAMES = 16, 2, (1, 2)
LOSS_RTOL = 1e-5
GRAD_SUM_RTOL = 1e-4
TRAINABLE = ("albedo", "emission", "emission_strength", "roughness")
SMALL_RUN = ["--device", "cpu", "--small", "--size", "16", "--bounces", "1",
             "--iters", "1"]
# the keys bench.py writes for a --small run (bench.py:182-205)
SMALL_KEYS = {"metric", "value", "unit", "vs_baseline", "alive_fraction",
              "alive_mrays"}


def bench_py_metric(fn, **names):
    """The ``"metric"`` expression of the dict function ``fn`` of the root
    bench.py builds (``main``, ``_bvh_row``, ``_bsdf_row``), read from its
    source and evaluated with ``names``."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    node = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == fn)
    expr = next(v for d in ast.walk(node) if isinstance(d, ast.Dict)
                for k, v in zip(d.keys, d.values)
                if isinstance(k, ast.Constant) and k.value == "metric")
    return eval(compile(ast.Expression(expr), "bench.py", "eval"), names)


def jax_case(name):
    """(JAX scene, matrices, config) as bench.py builds them for ``name``."""
    if name == "triangle":
        scene, cam = jbuiltin.single_triangle_scene()
        sky = "black"
    else:
        scene, cam = jbuiltin.default_scene(), jbuiltin.default_camera()
        sky = "gradient"
    return scene, jcamera_matrices(cam, 1.0), jax_config(sky)


def jax_config(sky):
    """The JAX config bench.py makes at SIZE, BOUNCES."""
    return JConfig(width=SIZE, height=SIZE, samples=1, max_bounces=BOUNCES,
                   sky=sky, use_nee=False, use_rr=False, compact=False,
                   compact_blocks=16, ray_sort="dynamic", row_chunks=0)


@functools.lru_cache(maxsize=None)
def jax_fwd_bwd(name):
    """bench.py's fwd+bwd of ``name``, jitted once: frame -> (loss, grads),
    value_and_grad of mean((img - 0)^2) over the material parameters."""
    scene, mats, cfg = jax_case(name)
    render_frame = jdispatch.get_render_frame("auto", scene, cfg)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss_fn(params, frame):
        m = dataclasses.replace(scene.materials, **params)
        s = dataclasses.replace(scene, materials=m)
        img = render_frame(s, mats, cfg, frame)
        return jnp.mean((img - target) ** 2)

    params = {k: getattr(scene.materials, k) for k in TRAINABLE}
    run = jax.jit(jax.value_and_grad(loss_fn))
    return lambda frame: run(params, jnp.uint32(frame))


def jax_loss_grads(name, frame):
    """(loss, {name: grad sum}) of bench.py's fwd+bwd on ``frame``."""
    loss, grads = jax_fwd_bwd(name)(frame)
    return float(loss), {k: float(jnp.sum(g)) for k, g in grads.items()}


def port_case(name):
    scene, cam, sky = bench.build_scene(name, "auto", 5, "cpu")
    args = bench.parse_args(["--bounces", str(BOUNCES)])[1]
    cfg = bench.make_config(args, SIZE, sky)
    return scene, camera_matrices(cam, 1.0), cfg


@pytest.mark.parametrize("name", ["triangle", "default"])
def test_step_scalar_matches_jax(name):
    scene, mats, cfg = port_case(name)
    target = torch.zeros((SIZE, SIZE, 3))
    step = bench.make_step(cfg, "auto")
    loss_grad = prender.scene_loss_grad(cfg, prender.BENCH_TRAINABLE, "auto")
    want_total = 0.0
    for frame in FRAMES:
        want_loss, want_sums = jax_loss_grads(name, frame)
        loss, grads = loss_grad(scene, mats, frame, target)
        np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
        assert set(grads) == set(want_sums)
        for k, g in grads.items():
            np.testing.assert_allclose(float(g.sum()), want_sums[k],
                                       rtol=GRAD_SUM_RTOL, err_msg=k)
        scalar = step(scene, mats, frame, target)
        assert torch.equal(scalar, bench.fold(loss, grads))
        want_total += want_loss + sum(want_sums.values())
    got_total = bench.run_steps(lambda f: step(scene, mats, f, target),
                                FRAMES)
    np.testing.assert_allclose(float(got_total), want_total,
                               rtol=GRAD_SUM_RTOL)


@pytest.mark.parametrize("name", ["triangle", "default"])
def test_alive_count_matches_jax(name):
    scene, mats, cfg = port_case(name)
    jscene, jmats, jcfg = jax_case(name)
    want = int(jgolden.count_alive_segments(jscene, jmats, jcfg,
                                            jnp.uint32(1)))
    assert bench.alive_segments(scene, mats, cfg, "auto") == want


N_BANDS, SCALING_STEP = 8, 1     # frames 8..15, each rows [0, 2)


def looped_scaling(scene, mats, cfg, step):
    """The scaling step with its band frames rendered one after another:
    (images, loss, grads)."""
    band = cfg.height // N_BANDS
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in reg.get_params(scene, None, TRAINABLE).items()}
    s, _ = reg.apply_params(scene, None, params)
    imgs = [golden.render_rows(s, mats, cfg, step * N_BANDS + i, 0, band)
            for i in range(N_BANDS)]
    loss = sum(torch.mean(img ** 2) for img in imgs) / N_BANDS
    grads = torch.autograd.grad(loss, list(params.values()))
    return (torch.stack(imgs).detach(), loss.detach(),
            dict(zip(params, grads)))


@pytest.fixture(scope="module")
def scaling_case():
    """The Cornell box with the JAX package's camera matrices, the bench's
    config at 16^2, 2 bounces, and ``scaling_loss_grad``'s step."""
    jscene, jcam = jbuiltin.cornell_box_scene()
    jm = jcamera_matrices(jcam, 1.0)
    scene, _, sky = bench.build_scene("cornell", "auto", 5, "cpu")
    mats = matrices_from_numpy(np.asarray(jm.inverse_projection),
                               np.asarray(jm.inverse_view),
                               np.asarray(jm.position), "cpu")
    cfg = bench.make_config(bench.parse_args(["--bounces", str(BOUNCES)])[1],
                            SIZE, sky)
    got = bench.scaling_loss_grad(N_BANDS, scene, mats, cfg)(SCALING_STEP)
    return jscene, jm, scene, mats, cfg, got


def test_scaling_batch_equals_loop(scaling_case):
    _, _, scene, mats, cfg, (img, loss, grads) = scaling_case
    want_img, want_loss, want = looped_scaling(scene, mats, cfg,
                                               SCALING_STEP)
    assert img.shape == (N_BANDS, SIZE // N_BANDS, SIZE, 3)
    assert torch.equal(img, want_img)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(TRAINABLE)
    for k in TRAINABLE:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, err_msg=k)


def test_scaling_batch_matches_jax_vmap(scaling_case):
    """``bench.py:_scaling_at``'s jitted loss (``jax.vmap`` of
    ``golden.render_rows`` over the frames, the mean of each frame's mean
    squared error), its value and grads with the images as ``aux``."""
    jscene, jm, _, _, _, (img, loss, grads) = scaling_case
    jcfg = jax_config("black")
    band = SIZE // N_BANDS

    def loss_fn(params, frame):
        m = dataclasses.replace(jscene.materials, **params)
        s = dataclasses.replace(jscene, materials=m)

        def one(f):
            rows = jgolden.render_rows(s, jm, jcfg, f, jnp.uint32(0), band)
            return jnp.mean(rows ** 2), rows

        frames = frame + jnp.arange(N_BANDS, dtype=jnp.uint32)
        losses, rows = jax.vmap(one)(frames)
        return jnp.mean(losses), rows

    params = {k: getattr(jscene.materials, k) for k in TRAINABLE}
    (want_loss, want_img), want = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jnp.uint32(SCALING_STEP * N_BANDS))
    flipped = np.abs(img.numpy() - np.asarray(want_img)).max(-1) > 1e-3
    assert flipped.mean() <= 0.01, flipped.mean()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3)
    for k in TRAINABLE:
        w = np.asarray(want[k])
        scale = float(np.abs(w).max())
        if scale == 0.0:   # roughness: the box is Lambertian only
            assert not grads[k].any(), k
            continue
        err = np.abs(grads[k].numpy() - w).max() / scale
        assert err <= 1e-3, (k, err)


@pytest.mark.parametrize("field", ["pixel_jitter", "edge_grads"])
def test_scaling_batch_refuses(field, scaling_case):
    _, _, scene, mats, cfg, _ = scaling_case
    with pytest.raises(ValueError, match=f"cfg.{field}"):
        golden.render_rows_frames(scene, mats, cfg.replace(**{field: True}),
                                  [0, 1], 0, 2)


def run_bench(args, code=None, env=None):
    cmd = ([sys.executable, "-c", code] if code else
           [sys.executable, "-m", "wc_path_tracer_tpu_torch.bench"]) + args
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)


def test_json_line():
    proc = run_bench(SMALL_RUN)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(rec) == SMALL_KEYS
    want = "Mrays/s/chip fwd+bwd (16^2 cornell, 1 bounces)"
    assert rec["metric"] == want == bench_py_metric(
        "main", mode="fwd+bwd", size=16,
        args=types.SimpleNamespace(scene="cornell"),
        cfg=types.SimpleNamespace(max_bounces=1))
    assert rec["unit"] == "Mrays/s" and rec["value"] > 0
    assert 0.0 < rec["alive_fraction"] <= 1.0
    lines = [json.loads(line[len("bench: launches "):])
             for line in proc.stderr.splitlines()
             if line.startswith("bench: launches ")]
    assert [r["row"] for r in lines] == ["headline"]
    assert lines[0]["counts"] == launches.named(launches.zeros())


def test_row_metric_strings(capsys, monkeypatch):
    assert bench.bvh_metric() == bench_py_metric("_bvh_row")
    assert bench.bsdf_metric() == bench_py_metric("_bsdf_row",
                                                  COMPACT_CONFIG_D=False)
    assert bench.headline_metric("fwd", 1024, "bunny", 4) == bench_py_metric(
        "main", mode="fwd", size=1024,
        args=types.SimpleNamespace(scene="bunny"),
        cfg=types.SimpleNamespace(max_bounces=4))
    cpu = torch.device("cpu")
    monkeypatch.setattr(bench, "ROW_ITERS", 1)
    monkeypatch.setattr(bench, "SCALING_ITERS", 1)
    bvh = bench.bvh_row(cpu, size=16, bounces=2)
    bsdf = bench.bsdf_row(cpu, size=16, bounces=2)
    assert bvh["metric"] == bench_py_metric("_bvh_row").replace(
        "512^2", "16^2").replace("4 bounces", "2 bounces")
    assert bsdf["metric"] == bench_py_metric(
        "_bsdf_row", COMPACT_CONFIG_D=False).replace(
        "1024^2", "16^2").replace("8 bounces", "2 bounces")
    assert set(bvh) == {"metric", "value", "unit"}
    assert set(bsdf) == {"metric", "value", "unit", "alive_fraction",
                         "alive_mrays"}
    assert bvh["value"] > 0 and bsdf["value"] > 0
    scene, mats, cfg = port_case("triangle")
    eff = bench.scaling_efficiency(8, scene, mats, cfg, 0.01, cpu)
    assert np.isfinite(eff) and eff > 0
    err = capsys.readouterr().err
    assert "bench: bvh_row: " in err and "bench: scaling_efficiency_8: " in err


def test_a_raising_row_fails_the_run():
    code = ("import sys\n"
            "from wc_path_tracer_tpu_torch import bench\n"
            "def boom(*a, **k):\n"
            "    raise RuntimeError('row failed')\n"
            "bench.bvh_row = boom\n"
            "bench.main(sys.argv[1:])\n")
    proc = run_bench(["--device", "cpu", "--size", "16", "--bounces", "1",
                      "--iters", "1"], code=code)
    assert proc.returncode != 0
    assert "Traceback" in proc.stderr and "row failed" in proc.stderr
    assert proc.stdout.strip() == ""


def test_no_silent_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run_bench(["--small", "--size", "16"], env=env)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert proc.stdout.strip() == ""


def test_imports_no_jax():
    code = ("import sys\n"
            "from wc_path_tracer_tpu_torch import bench\n"
            "bench.main(sys.argv[1:])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'wc_path_tracer_tpu', 'bench'))\n"
            "print(repr(bad))\n")
    proc = run_bench(SMALL_RUN, code=code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_baseline_markers(tmp_path):
    """``vs_baseline`` reads the first ``torch-bench-baseline`` marker of
    its (mode, size, scene) from PERF.md, never BASELINE.md's TPU rows."""
    perf = tmp_path / "PERF.md"
    perf.write_text(
        "<!-- bench-baseline mode=fwd+bwd size=1024 scene=cornell value=9 -->\n"
        "<!-- torch-bench-baseline mode=fwd size=1024 scene=cornell "
        "value=50.5 -->\n"
        "<!-- torch-bench-baseline mode=fwd+bwd size=1024 scene=cornell "
        "value=40.25 -->\n"
        "<!-- torch-bench-baseline mode=fwd+bwd size=1024 scene=cornell "
        "value=1 -->\n")
    assert bench.read_baseline("fwd+bwd", 1024, "cornell", perf) == 40.25
    assert bench.read_baseline("fwd", 1024, "cornell", perf) == 50.5
    assert bench.read_baseline("fwd", 512, "cornell", perf) is None
    assert bench.read_baseline("fwd", 1024, "cornell",
                               tmp_path / "missing.md") is None
    assert os.path.basename(bench.BASELINE_FILE) == "PERF.md"
    assert os.path.dirname(bench.BASELINE_FILE) == ROOT
