"""The NEE configuration's plain reference (perfbench/reference/nee.py)
against the measured program's plain path on the CPU: the scene the
configuration loads, frames with next-event estimation and MIS on and off
over Lambertian and GGX lobes on the brute-force path and the cluster
sweep's plain twin, the bfloat16 control, what ``covers`` refuses, the
cell through its own loop and check, and the reader of
``nee_query_roofline.serve``.

The frames put an icosphere inside the configuration's box in place of the
bunny: 80 triangles (92 with the box, under dispatch "auto"'s 256-slot
crossover: brute force) or 1,280 (1,292: the sweep)."""

import json

import numpy as np
import pytest
import torch

from perfbench import calibrate, check, harness, peaks, program
from perfbench.reference import nee
from perfbench.reference import post as ref_post
from perfbench.scenes import cornell_quads

from .helpers import SEED, run_small, small

CELL = "bunny-box-nee-serve"
CONFIG = harness.ROOT / "perfbench/configs/bunny-box-nee.json"


def _config():
    return json.loads(CONFIG.read_text())


def _limits(cell=CELL):
    return harness.cell_parts(harness.spec(), cell)[3]


def test_the_configuration_puts_the_bunny_in_the_box():
    """20,492 triangles: the box's 12 as "cornell_quads" makes them, then
    the glTF bunny's 20,480, all of material 4 and inside the box."""
    cfg = _config()
    raw = harness.load_scene(cfg)
    box = cornell_quads.load(dict(cfg["scene"], boxes=[]), str(harness.ROOT))
    n_box = len(box["vertices"])
    assert len(raw["indices"]) // 3 == 20_492
    assert np.array_equal(raw["indices"][:36], box["indices"])
    assert np.array_equal(raw["vertices"][:n_box], box["vertices"])
    assert np.array_equal(raw["tri_material"][:12], box["tri_material"])
    assert (raw["tri_material"][12:] == 4).all()
    assert not raw["normals"][:n_box].any()
    bunny = raw["vertices"][n_box:]
    assert len(bunny) == 10_242
    lo, hi = bunny.min(0), bunny.max(0)
    assert lo[0] > 0.0 and hi[0] < 555.0 and lo[2] > -555.0 and hi[2] < 0.0
    assert 0.0 <= lo[1] < 0.01 and 230.0 < hi[1] < 240.0
    assert raw["materials"] == cfg["scene"]["materials"]
    assert raw["materials"][4]["mtype"] == nee.GGX
    assert nee.covers(raw, cfg["render"]) is None


def test_the_programs_light_slots_come_in_the_references_order():
    """The light pick maps a draw to a light by the order of the light set:
    the program's emissive triangle slots (in the order its scene stores
    them) hold the raw triangles of the reference's light set, in its
    order."""
    from wc_path_tracer_tpu_torch.render import golden

    raw = harness.load_scene(_config())
    scene, _ = program.build_scene(raw, "cpu")
    weights = golden._light_tables(scene)[0]
    slots = torch.nonzero(weights > 0).squeeze(1) - scene.spheres.capacity
    program_tris = scene.mesh.indices.view(-1, 3)[slots].long()
    lights = nee.light_set(nee.prepare(raw, "cpu"))
    assert not lights.on_sphere.any() and len(lights.index) == 2
    ref_tris = torch.as_tensor(raw["indices"].reshape(-1, 3)[
        lights.index.numpy()]).long()
    assert torch.equal(program_tris, ref_tris)


def _raw(subdivisions, lobe):
    """The configuration's box holding an icosphere of radius 100 at the
    bunny's place, of material 4 as a GGX conductor or Lambertian."""
    from wc_path_tracer_tpu_torch.models import procedural

    scene = _config()["scene"]
    box = cornell_quads.load(dict(scene, boxes=[]), str(harness.ROOT))
    v, idx = procedural.icosphere(subdivisions, 100.0)
    v = np.asarray(v, np.float32) + np.float32([278.0, 120.0, -280.0])
    idx = np.asarray(idx, np.int32).reshape(-1)
    mats = [dict(m) for m in scene["materials"]]
    if lobe == "lambert":
        mats[4] = {"mtype": nee.LAMBERTIAN, "albedo": mats[4]["albedo"]}
    n = len(box["vertices"])
    return dict(box, materials=mats,
                vertices=np.concatenate([box["vertices"], v]),
                indices=np.concatenate([box["indices"], idx + n]),
                tri_material=np.concatenate([
                    box["tri_material"],
                    np.full(len(idx) // 3, 4, np.int32)]))


@pytest.mark.parametrize("lobe", ["ggx", "lambert"])
@pytest.mark.parametrize("mis", [True, False], ids=["mis", "nee_only"])
@pytest.mark.parametrize("backend", ["golden", "sweep"])
def test_program_frames_match_the_reference(backend, mis, lobe):
    """32 x 32, 2 bounces, 3 accumulated frames through dispatch "auto":
    the frames agree within ``cornell-serve``'s limits, and NEE lights
    more than twice the pixels that a frame without it lights."""
    from wc_path_tracer_tpu_torch.render import dispatch, golden
    from wc_path_tracer_tpu_torch.scene.camera import camera_matrices

    raw = _raw(1 if backend == "golden" else 3, lobe)
    render = dict(_config()["render"], width=32, height=32, max_bounces=2,
                  mis=mis)
    post = harness.cell_parts(harness.spec(), CELL)[2]["post"]
    scene, cam = program.build_scene(raw, "cpu")
    cfg = program.render_config(render)
    frame_fn = dispatch.get_render_frame("auto", scene, cfg)
    assert frame_fn.backend == backend
    mats = camera_matrices(cam, 1.0)
    ref = nee.prepare(raw, "cpu")
    img = ref_img = None
    worst = {}
    with torch.no_grad(), nee.exact_matmuls():
        for f in range(3):
            img = golden.accumulate(img, frame_fn(scene, mats, cfg, f), f)
            ref_img = nee.accumulate(ref_img, nee.render_frame(ref, render, f),
                                     f)
            n = check.serve_numbers(
                img, ref_post.finalize(img, post["tonemap"], post["gamma"],
                                       post["bloom"]),
                ref_img, ref_post.finalize(ref_img, post["tonemap"],
                                           post["gamma"], post["bloom"]))
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in n.items()}
        dark = nee.render_frame(ref, dict(render, use_nee=False), 2)
    limits = _limits("cornell-serve")
    assert all(worst[k] <= limits[k] for k in limits), worst

    def lit(image):
        return float((image.amax(-1) > 0.0).float().mean())

    assert lit(frame_fn(scene, mats, cfg, 2)) > 2.0 * lit(dark) > 0.0


def test_the_bfloat16_control_fails_the_limits():
    numbers = calibrate.control_reading(CELL, SEED, torch.device("cpu"),
                                        small(16))
    limits = _limits()
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("field", ["pixel_jitter", "edge_grads"])
def test_covers_refuses_jitter_and_the_edge_estimator(field):
    raw = harness.load_scene(_config())
    render = _config()["render"]
    for ok in (dict(use_nee=False), dict(mis=False), dict(use_rr=True)):
        assert nee.covers(raw, dict(render, **ok)) is None
    why = nee.covers(raw, dict(render, **{field: True}))
    assert why and field in why


def test_the_cell_matches_its_reference():
    line = run_small(CELL, size=16, seconds=2.0)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["hdr_px_share"]["value"] == 0.0
    assert line["checks"]["u8_px_share"]["value"] == 0.0


def test_nee_query_roofline_reads_the_query_kernels_alone():
    """The reader's bound is 5 closest-hit and 5 shadow queries a frame at
    64 x 32 over 100 triangles and 2 spheres, against the device time of
    the B1, B3 and H1 kernels alone; no query kernel, no reading."""
    read = harness.metric_reader("nee_query_roofline.serve")
    kernels = [("sweep_kernel<4, 4>(Params)", 0, 2_000_000),
               ("bvh_walk_kernel(Params)", 3, 500_000),
               ("brute_hit(Params)", 4, 1_500_000),
               ("shade_segment(Params)", 5, 7_000_000),
               ("vectorized_elementwise_kernel", 9, 9_000_000)]

    def view(k):
        stretch = type("S", (), {"kernels": k, "units": 2})()
        return harness.MetricView(
            stretch=stretch, world=1,
            render=dict(width=64, height=32, samples=1, max_bounces=4),
            scene_sizes=dict(triangles=100, spheres=2), spans={})

    lanes, scene_bytes = 64 * 32, 100 * 36 + 2 * 16
    ops_s = 54 * lanes / peaks.H100_FP32_FLOPS
    hit_s = max(ops_s, (36 * lanes + scene_bytes) / peaks.H100_HBM_BYTES)
    shadow_s = max(ops_s, (29 * lanes + scene_bytes) / peaks.H100_HBM_BYTES)
    want = 100.0 * 2 * 5 * (hit_s + shadow_s) / 4e-3
    assert read(view(kernels)) == pytest.approx(want, rel=1e-12)
    assert read(view(kernels[3:])) is None
