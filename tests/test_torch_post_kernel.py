"""The serving post-processing kernels P1 (kernels/post.py) on the CPU.

The kernels run only on the card, where tests/test_torch_gpu.py holds them
against ``_finalize`` bit for bit.  Here: the CPU's ``Renderer.output``
takes ``_finalize`` and launches nothing; the wrapper refuses CPU tensors;
its tables (tonemap ids, gamma modes, stages, the scalars' layout) agree
with csrc/post_frame.cu; its pyramid has ``bloom_pyramid``'s levels; and
its gamma follows ``torch.pow``'s dispatch on the exponent.
"""

import re

import numpy as np
import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import build, launches, post
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.ops import bloom as bl
from wc_path_tracer_tpu_torch.ops import tonemap as tm
from wc_path_tracer_tpu_torch.render.renderer import Renderer, _finalize
from wc_path_tracer_tpu_torch.utils import profiling

SOURCE = build.source("post_frame").read_text()


def _enum(name):
    """{entry: value} of the C enum ``name`` of post_frame.cu."""
    body = re.search(r"enum " + name + r" \{([^}]*)\}", SOURCE).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def _constant(name):
    return int(re.search(r"\b" + name + r" = (\d+)", SOURCE).group(1))


@pytest.mark.parametrize("tonemap, bloom", [("aces", True),
                                            ("pbr_neutral", False)])
def test_output_on_cpu_takes_finalize(tonemap, bloom):
    """On the CPU ``Renderer.output`` is ``_finalize``'s image, launches no
    P1 kernel and counts no ``post.pixels``."""
    scene, cam = builtin.cornell_box_scene(device="cpu")
    cfg = RenderConfig(width=24, height=16, max_bounces=1, bloom=bloom,
                       tonemap=tonemap, gamma=2.2)
    r = Renderer(scene, cam, cfg, device="cpu")
    r.step(1)
    before = launches.read_counts()
    with profiling.counting() as counts:
        out = r.output()
    assert launches.read_counts() == before
    assert counts == {}
    want = _finalize(r.image, tonemap, 2.2, bloom, cfg.bloom_threshold,
                     cfg.bloom_knee, cfg.bloom_strength).numpy()
    assert out.dtype == np.uint8 and np.array_equal(out, want)


def test_post_kernel_refuses_cpu_tensors(monkeypatch):
    """The wrapper launches on CUDA tensors only, naming the device it was
    given, before any library is loaded; nothing is counted."""
    monkeypatch.setattr(launches, "library", None)
    before = launches.read_counts()
    with pytest.raises(ValueError, match="post_frame_kernel: CUDA tensors "
                                         "only, got cpu"):
        post.post_frame_kernel(torch.zeros(8, 8, 3), "aces", 2.2, True, 1.0,
                               0.1, 1.0)
    assert launches.read_counts() == before


def test_post_kernel_tables_match_the_source():
    """The wrapper's tonemap ids are ``TONEMAPS``' order and the source's
    Tonemap enum; its gamma modes, stages and the scalars' layout are the
    source's; every tonemap's scalars fit the kernel's array."""
    names = {"k" + "".join(p.title() for p in name.split("_")): i
             for name, i in post.TONEMAP_IDS.items()}
    assert list(post.TONEMAP_IDS) == list(tm.TONEMAPS)
    assert _enum("Tonemap") == names
    modes = _enum("PowMode")
    assert list(modes.values()) == list(range(len(post.POW_MODES)))
    assert list(modes) == ["k" + "".join(p.title() for p in m.split("_"))
                           for m in post.POW_MODES]
    assert [_constant(n) for n in ("kDown", "kDownPrefilter", "kUp",
                                   "kComposite")] == [
        post.DOWN, post.DOWN_PREFILTER, post.UP, post.COMPOSITE]
    assert _constant("kConsts") == post.N_CONSTS
    assert _constant("kTm") == post.TM_AT
    for name in tm.TONEMAPS:
        arr, tm_id, mode = post.constants(name, 2.2, 1.0, 0.1, 1.0)
        assert len(arr) == post.N_CONSTS and tm_id == post.TONEMAP_IDS[name]
        assert post.TM_AT + len(post._tonemap_constants(name)) \
            <= post.N_CONSTS
        assert all(float(np.float32(v)) == v for v in arr)
    with pytest.raises(ValueError, match=re.escape(
            f"unknown tonemap 'nope'; options: {sorted(tm.TONEMAPS)}")):
        post.constants("nope", 2.2, 1.0, 0.1, 1.0)


@pytest.mark.parametrize("h, w", [(1024, 1024), (512, 512), (37, 53),
                                  (3, 5), (1, 1), (130, 9)])
def test_pyramid_levels_are_bloom_pyramids(h, w):
    """``post.pyramid`` lists the (h, w) of each level ``bloom_pyramid``
    builds; the launches a frame are twice their count (16 at 1024^2, 14
    at 512^2)."""
    chain = [bl.prefilter(bl.downsample_box13(torch.zeros(h, w, 3)))]
    while len(chain) < 8 and min(chain[-1].shape[:2]) > 4:
        chain.append(bl.downsample_box13(chain[-1]))
    sizes = post.pyramid(h, w)
    assert sizes == [tuple(c.shape[:2]) for c in chain]
    assert 2 * len(sizes) == {1024: 16, 512: 14}.get(h, 2 * len(sizes))


@pytest.mark.parametrize("gamma, mode", [
    (1.0, "no_gamma"), (2.2, "powf"), (2.0, "sqrt"), (-2.0, "rsqrt"),
    (-1.0, "recip"), (0.5, "square"), (1 / 3, "cube"), (-0.5, "inv_square"),
    (float("inf"), "fill1"), (1.0000000001, "powf")])
def test_gamma_follows_torch_pow_dispatch(gamma, mode):
    """``pow_mode`` picks the branch that ``torch.pow(x, 1 / gamma)`` takes
    (sqrt, rsqrt and reciprocal on the exponent as given, the products on
    its float32), and the exponent the kernel's powf reads; on the CPU
    ``torch.pow(x, 1 / gamma)`` gives that branch's values."""
    got, exponent = post.pow_mode(gamma)
    assert post.POW_MODES[got] == mode
    if mode != "no_gamma":
        assert exponent == float(np.float32(1.0 / gamma))
    x = torch.tensor([0.0, 0.25, 0.5, 1.0, 2.0])
    want = {"powf": torch.pow(x, exponent), "sqrt": x.sqrt(),
            "square": x * x, "cube": x * x * x, "recip": 1.0 / x,
            "fill1": torch.ones_like(x)}.get(mode)
    if want is not None:
        torch.testing.assert_close(torch.pow(x, 1.0 / gamma), want,
                                   rtol=0, atol=0, equal_nan=True)
