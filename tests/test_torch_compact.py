"""Alive-lane compaction (``RenderConfig.compact``) in the port.

Compaction only reschedules work: the same lanes run the same per-lane
math and carry their PCG streams, so the port's compacted frames and grads
must equal its plain ones bit for bit (the JAX package allows f32
reassociation, rtol 2e-6, because XLA fuses the permuted program
differently; the port's PyTorch ops round each lane alike wherever it
sits).  Against the JAX package's own compaction: frames to its rtol 2e-6
plus 2e-7 and albedo grads to its rtol 5e-5 plus 1e-8 on the default scene
(no 555-unit box, where a roundoff-decided bounce flips the reference,
ROADMAP C1), the frame evaluated op by op (jitted, XLA-CPU contracts FMAs
and flips such a bounce on the default scene too), the grads jitted.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.render import dispatch, golden

from tests.test_torch_nee import op_by_op, scene_case
from tests.test_torch_render import _case as forward_case

torch.set_num_threads(2)

FRAME = 1


def frames(ts, tm, cfg, renderer="golden"):
    """(plain frame, compacted frame) of the port, 8 compaction blocks."""
    fn = dispatch.get_intersect_fn(renderer, ts, cfg)
    with torch.no_grad():
        return (golden.render_frame(ts, tm, cfg, FRAME, fn),
                golden.render_frame(ts, tm, cfg.replace(
                    compact=True, compact_blocks=8), FRAME, fn))


@pytest.mark.parametrize("rr", [False, True], ids=["no-rr", "rr"])
def test_compact_image_bitwise_plain(rr):
    """tests/test_compact.py's Cornell case, 32 x 32, 6 bounces, NEE, RR
    from bounce 1 or none: the compacted frame is the plain frame."""
    _, _, ts, tm = scene_case("cornell")
    cfg = RenderConfig(width=32, height=32, samples=1, max_bounces=6,
                       sky="black", use_nee=True, use_rr=rr,
                       rr_start_bounce=1)
    a, b = frames(ts, tm, cfg)
    assert torch.equal(a, b)
    assert float(a.max()) > 0.0


def test_compact_default_scene_with_sky_miss_kills():
    """Sky misses as the kill source (compact_from resolves to 1): bitwise
    the plain frame, and the JAX package's compacted frame to its
    tolerance."""
    js, jm, ts, tm = scene_case("default")
    kw = dict(width=24, height=24, samples=1, max_bounces=4)
    a, b = frames(ts, tm, RenderConfig(**kw))
    assert torch.equal(a, b)
    want = np.asarray(op_by_op(jgolden.render_frame)(
        js, jm, JConfig(**kw, compact=True, compact_blocks=8), FRAME))
    np.testing.assert_allclose(b.numpy(), want, rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("renderer", ["sweep", "pallas"])
def test_compact_through_the_kernel_paths(renderer):
    """The bunny-like mesh, 32 x 32, 4 bounces, RR from bounce 1, through
    the cluster sweep (plain twin) and the BVH walk: the compacted frame
    is the plain frame.  (A sweep block holds other lanes when compacted,
    so an exact cross-cluster t-tie may go the other way; none does
    here.)"""
    _, _, ts, tm = forward_case("bunny")
    cfg = RenderConfig(width=32, height=32, samples=1, max_bounces=4,
                       use_rr=True, rr_start_bounce=1)
    a, b = frames(ts, tm, cfg, renderer)
    assert torch.equal(a, b)


def albedo_grads(ts, tm, cfg):
    alb = ts.materials.albedo.detach().clone().requires_grad_(True)
    s = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, albedo=alb))
    loss = torch.mean(golden.render_frame(s, tm, cfg, FRAME))
    return torch.autograd.grad(loss, alb)[0].numpy()


def test_compact_grads_match_plain_and_jax():
    """tests/test_compact.py's grad case (16 x 16, 5 bounces, RR from
    bounce 1, d mean(frame) / d albedo): bitwise the plain path's grads on
    the Cornell box; on the default scene, the JAX package's compacted
    grads to its rtol 5e-5."""
    kw = dict(width=16, height=16, samples=1, max_bounces=5, use_rr=True,
              rr_start_bounce=1)
    _, _, ts, tm = scene_case("cornell")
    cfg = RenderConfig(**kw, sky="black")
    plain = albedo_grads(ts, tm, cfg)
    np.testing.assert_array_equal(
        albedo_grads(ts, tm, cfg.replace(compact=True, compact_blocks=8)),
        plain)
    assert np.abs(plain).max() > 0.0

    js, jm, ts, tm = scene_case("default")
    jcfg = JConfig(**kw, compact=True, compact_blocks=8)

    def loss(albedo):
        s = dataclasses.replace(js, materials=dataclasses.replace(
            js.materials, albedo=albedo))
        return jnp.mean(jgolden.render_frame(s, jm, jcfg, FRAME))

    want = np.asarray(jax.jit(jax.grad(loss))(js.materials.albedo))
    got = albedo_grads(ts, tm, RenderConfig(**kw, compact=True,
                                            compact_blocks=8))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-8)


def test_compact_from_resolved_tracks_rr():
    """The JAX package's rule: RR's first bounce + 1, else 1, unless set."""
    for kw in ({}, dict(use_rr=True, rr_start_bounce=2), dict(compact_from=5),
               dict(use_rr=True, compact_from=0)):
        assert RenderConfig(**kw).compact_from_resolved \
            == JConfig(**kw).compact_from_resolved, kw
    assert RenderConfig(use_rr=True, rr_start_bounce=2) \
        .compact_from_resolved == 3


def test_compact_odd_block_counts_and_late_start():
    """Block counts that do not divide the ray count are lowered until
    they do (here 7 -> 6 for 24 x 24), a start past the last bounce runs
    every bounce dense, and two samples carry the seed across."""
    _, _, ts, tm = scene_case("default")
    cfg = RenderConfig(width=24, height=24, samples=2, max_bounces=3,
                       use_rr=True, rr_start_bounce=1)
    with torch.no_grad():
        want = golden.render_frame(ts, tm, cfg, FRAME)
        for kw in (dict(compact_blocks=7), dict(compact_from=9),
                   dict(compact_blocks=576), dict(compact_from=0)):
            got = golden.render_frame(ts, tm, cfg.replace(compact=True, **kw),
                                      FRAME)
            assert torch.equal(got, want), kw


def test_count_alive_segments_matches_jax():
    """The frame's alive lane-segments (first sample, times the samples)
    with RR and sky misses, against the JAX package's count (op by op, so
    no roundoff-decided kill differs), through the brute path and the
    active sweep backend."""
    js, jm, ts, tm = scene_case("default")
    kw = dict(width=24, height=24, samples=2, max_bounces=4, use_rr=True,
              rr_start_bounce=1)
    want = int(op_by_op(jgolden.count_alive_segments)(js, jm, JConfig(**kw),
                                                      FRAME))
    cfg = RenderConfig(**kw)
    assert golden.count_alive_segments(ts, tm, cfg, FRAME) == want
    per = golden.alive_per_bounce(ts, tm, cfg, FRAME)
    assert per[0] == 24 * 24 and bool(torch.all(per[1:] <= per[:-1]))
    assert want < 24 * 24 * 2 * 5
    _, _, bs, bm = forward_case("bunny")
    bcfg = RenderConfig(**dict(kw, width=16, height=16))
    assert golden.count_alive_segments(
        bs, bm, bcfg, FRAME, dispatch.get_intersect_fn("sweep", bs, bcfg)) \
        == golden.count_alive_segments(bs, bm, bcfg, FRAME)
