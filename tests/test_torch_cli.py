"""The port's command-line interface, on the CPU (``--device cpu``, 16 x 16).

``render`` goes through ``Renderer``: a render, a checkpoint and a resume
write the PNG a Renderer stepped as many frames writes; ``--metrics`` logs
one record per frame with the alive share; ``--debug-bvh`` overlays the
BVH; ``invert`` trains and lowers the loss; ``info`` names the device;
``render`` started as one of several ranks exits before writing anything.
Without a card and without ``--device`` every command exits non-zero with
the device error.
"""

import json

import numpy as np
import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.cli import main
from wc_path_tracer_tpu_torch.io.image import read_png
from wc_path_tracer_tpu_torch.kernels import launches
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

SMALL = ["--device", "cpu", "--width", "16", "--height", "16",
         "--bounces", "2"]


def test_render_resume_equals_renderer(tmp_path):
    out, ck, m = (str(tmp_path / n) for n in ("a.png", "ck", "m.jsonl"))
    main(["render", *SMALL, "--scene", "cornell", "--nee", "--frames", "2",
          "--out", out, "--checkpoint", ck, "--metrics", m, "--bloom",
          "--tonemap", "aces"])
    recs = [json.loads(line) for line in open(m)]
    assert [r["frame"] for r in recs] == [1, 2]
    assert all(0.0 < r["alive_fraction"] <= 1.0 for r in recs)
    assert all(r["kernel_launches"] == launches.named(launches.zeros())
               for r in recs)
    resumed = str(tmp_path / "b.png")
    r = main(["render", *SMALL, "--scene", "cornell", "--nee", "--frames",
              "1", "--out", resumed, "--resume", ck, "--tonemap", "aces"])
    assert r.frame_count == 3

    cfg = RenderConfig(width=16, height=16, max_bounces=2, sky="black",
                       use_nee=True, bloom=True)
    want = Renderer(*builtin.cornell_box_scene(device="cpu"), cfg,
                    device="cpu")
    want.step(3)
    np.testing.assert_array_equal(read_png(resumed),
                                  want.output(tonemap="aces"))
    want2 = Renderer(*builtin.cornell_box_scene(device="cpu"), cfg,
                     device="cpu")
    want2.step(2)
    np.testing.assert_array_equal(read_png(out), want2.output(tonemap="aces"))


def test_render_debug_bvh(tmp_path):
    out, bvh = str(tmp_path / "a.png"), str(tmp_path / "bvh.png")
    main(["render", *SMALL, "--scene", "cornell", "--frames", "1",
          "--out", out, "--debug-bvh", bvh])
    plain, over = read_png(out), read_png(bvh)
    assert over.shape == plain.shape == (16, 16, 3)
    assert not np.array_equal(over, plain)


def test_invert_lowers_the_loss(tmp_path, capsys):
    hist = main(["invert", *SMALL, "--scene", "cornell", "--nee",
                 "--steps", "3", "--log-every", "1", "--out-dir", str(tmp_path / "opt"),
                 "--metrics", str(tmp_path / "m.jsonl")])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert (tmp_path / "opt" / "manifest.json").exists()
    assert len(open(tmp_path / "m.jsonl").readlines()) == 3
    assert "final loss" in capsys.readouterr().err


def test_info(capsys):
    main(["info", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "rank: 0/1" in out


def test_no_card_without_device_exits_with_the_device_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    for argv in (["info"], ["render", "--frames", "1"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code != 0
        assert "no CUDA device is available" in capsys.readouterr().err


def test_render_refuses_a_multi_rank_launch(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    out = tmp_path / "r.png"
    with pytest.raises(SystemExit, match="render runs in one process"):
        main(["render", *SMALL, "--scene", "cornell", "--frames", "1",
              "--out", str(out)])
    assert not out.exists()
