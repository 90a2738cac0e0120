"""Port vs JAX package: tonemaps, bloom, PNG I/O and the BVH overlay.

Post-processing is elementwise and stencil arithmetic in the same float32
operation order in both packages, so every tonemap and the bloom chain
must agree to rtol 1e-5 / atol 1e-6 at an odd size (37 x 53, which takes
the odd-size padding of every pyramid level), and bloom's autograd grad
must agree with ``jax.grad`` to the same tolerance on 16 x 16.  The port's
bloom stencils are also held against the literal shader oracles of
tests/test_bloom.py.  The BVH overlay is host NumPy in both packages and
must be bit for bit.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.io import image as jimage
from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.ops import bloom as jbloom
from wc_path_tracer_tpu.ops import tonemap as jtm
from wc_path_tracer_tpu.render import debug as jdebug
from wc_path_tracer_tpu.scene import camera as jcamera

from test_bloom import _oracle_down13, _oracle_tent9

from wc_path_tracer_tpu_torch.io import image
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.ops import bloom
from wc_path_tracer_tpu_torch.ops import tonemap as tm
from wc_path_tracer_tpu_torch.render import debug
from wc_path_tracer_tpu_torch.scene import camera

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _hdr(shape, seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0.0, 6.0, shape).astype(np.float32)
    img[r.random(shape[:2]) < 0.05] = 0.0       # black pixels
    img[r.random(shape[:2]) < 0.02] *= 8.0      # highlights above the clamp
    return img


def test_tonemaps_match_jax():
    assert sorted(tm.TONEMAPS) == sorted(jtm.TONEMAPS)
    img = _hdr((37, 53, 3), 0)
    for name in tm.TONEMAPS:
        got = tm.apply(torch.from_numpy(img), name).numpy()
        want = np.asarray(jtm.apply(jnp.asarray(img), name))
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    for fn in ("srgb_oecf", "srgb_to_linear", "luminance"):
        x = np.clip(img / 6.0, 0.0, 1.0)
        np.testing.assert_allclose(
            getattr(tm, fn)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jtm, fn)(jnp.asarray(x))), err_msg=fn, **TOL)
    with pytest.raises(ValueError, match="unknown tonemap"):
        tm.apply(torch.zeros(2, 2, 3), "nope")


def test_bloom_matches_jax_at_odd_size():
    img = _hdr((37, 53, 3), 1)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    half = bloom.bloom_pyramid(t, 1.0, 0.1)
    assert half.shape == (19, 27, 3)
    np.testing.assert_allclose(half.numpy(), np.asarray(jax.jit(
        lambda x: jbloom.bloom_pyramid(x, 1.0, 0.1))(j)), **TOL)
    full = bloom.bloom(t, 0.8, 0.2, max_mips=3)
    np.testing.assert_allclose(full.numpy(), np.asarray(jax.jit(
        lambda x: jbloom.bloom(x, 0.8, 0.2, max_mips=3))(j)), **TOL)
    np.testing.assert_allclose(
        bloom.composite(t, full).numpy(),
        np.asarray(jbloom.composite(j, jnp.asarray(full.numpy()))), **TOL)
    np.testing.assert_allclose(bloom.composite(t).numpy(),
                               np.asarray(jbloom.composite(j)), **TOL)


def test_bloom_stencils_match_shader_oracles():
    r = np.random.default_rng(7)
    src = r.uniform(0, 4, (12, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        bloom.downsample_box13(torch.from_numpy(src)).numpy(),
        _oracle_down13(src, 6, 8), rtol=1e-5, atol=1e-5)
    src = r.uniform(0, 4, (5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        bloom.upsample_tent9(torch.from_numpy(src), 10, 14).numpy(),
        _oracle_tent9(src, 10, 14), rtol=1e-5, atol=1e-5)


def test_bloom_grad_matches_jax():
    img = _hdr((16, 16, 3), 2)
    w = np.random.default_rng(3).normal(size=img.shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(jbloom.bloom(x, 1.0, 0.1) * w)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(img)))
    x = torch.from_numpy(img).requires_grad_(True)
    (g,) = torch.autograd.grad(
        torch.sum(bloom.bloom(x, 1.0, 0.1) * torch.from_numpy(w)), x)
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(g.numpy(), want, **TOL)


def _no_pil(monkeypatch):
    """Make ``from PIL import Image`` raise ImportError (the fallback
    encoder and decoder)."""
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "zlib"])
def test_png_round_trip_and_jax_pixels(tmp_path, monkeypatch, pil):
    img = np.random.default_rng(4).integers(0, 256, (13, 21, 3), np.uint8)
    if not pil:
        _no_pil(monkeypatch)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "jax.png")
    image.write_png(ours, img)
    jimage.write_png(theirs, img)
    np.testing.assert_array_equal(image.read_png(ours), img)
    np.testing.assert_array_equal(image.read_png(theirs), img)
    np.testing.assert_array_equal(jimage.read_png(ours), img)
    with pytest.raises(ValueError, match="uint8"):
        image.write_png(ours, img.astype(np.float32))
    image.write_npy(str(tmp_path / "a.npy"), img)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), img)


def test_png_without_ihdr_raises_value_error(tmp_path, monkeypatch):
    _no_pil(monkeypatch)
    good = str(tmp_path / "good.png")
    image.write_png(good, np.zeros((2, 2, 3), np.uint8))
    data = open(good, "rb").read()
    ihdr_len = 8 + 4 + 4 + 13 + 4       # signature + length, tag, body, crc
    bad = tmp_path / "bad.png"
    bad.write_bytes(data[:8] + data[ihdr_len:])
    with pytest.raises(ValueError, match="IHDR"):
        image.read_png(str(bad))


def test_aabb_overlay_matches_jax_bitwise():
    jscene, jcam = jbuiltin.cornell_box_scene()
    scene, _ = builtin.cornell_box_scene(device="cpu")
    jm = jcamera.camera_matrices(jcam, 40 / 32)
    tmats = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                       np.asarray(jm.inverse_view),
                                       np.asarray(jm.position), "cpu")
    img = np.random.default_rng(5).uniform(0, 1, (32, 40, 3)).astype(
        np.float32)
    want = jdebug.draw_aabb_overlay(img, jm, jscene.mesh.bvh_min,
                                    jscene.mesh.bvh_max)
    got = debug.draw_aabb_overlay(torch.from_numpy(img), tmats,
                                  scene.mesh.bvh_min, scene.mesh.bvh_max)
    assert not np.array_equal(got, img)
    np.testing.assert_array_equal(got, want)
    some = np.array([0, 3, 5])
    np.testing.assert_array_equal(
        debug.draw_aabb_overlay(img, tmats, scene.mesh.bvh_min,
                                scene.mesh.bvh_max, node_ids=some,
                                color=(0.0, 1.0, 0.0)),
        jdebug.draw_aabb_overlay(img, jm, jscene.mesh.bvh_min,
                                 jscene.mesh.bvh_max, node_ids=some,
                                 color=(0.0, 1.0, 0.0)))
