"""Port vs JAX package: PCG streams, intersectors and BSDF helpers.

Inputs are made with numpy from fixed seeds and fed to both packages.
Integer streams must match bit for bit.  Floats from the same formulas can
differ in the last bits: XLA-CPU may contract a multiply and an add into one
FMA where torch rounds each, and the two libraries' log/cos/sqrt round
differently in the last place; hence the stated relative tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wc_path_tracer_tpu.ops import bsdf as jbsdf
from wc_path_tracer_tpu.ops import intersect as jix
from wc_path_tracer_tpu.ops import rng as jrng
from wc_path_tracer_tpu.render import golden as jgolden

from wc_path_tracer_tpu_torch.ops import bsdf, rng
from wc_path_tracer_tpu_torch.ops import intersect as ix
from wc_path_tracer_tpu_torch.render import golden

torch.set_num_threads(2)

N = 1 << 16


def _u32(seed):
    return np.random.default_rng(seed).integers(0, 2**32, N, dtype=np.uint32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _state(x):
    return _t(x.astype(np.int64))


def _same_u32(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want, np.uint32))
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


def test_pcg_hash_and_pixel_seed_bit_exact():
    x = _u32(0)
    _same_u32(rng.pcg_hash(_state(x)), jrng.pcg_hash(jnp.asarray(x)))
    pix = np.arange(N, dtype=np.uint32)
    for frame in (0, 1, 7, 2**32 - 1):
        _same_u32(rng.pixel_seed(_state(pix), frame),
                  jrng.pixel_seed(jnp.asarray(pix), np.uint32(frame)))


def test_rand_stream_bit_exact():
    s_t, s_j = _state(_u32(1)), jnp.asarray(_u32(1))
    for _ in range(8):
        v_t, s_t = rng.rand(s_t)
        v_j, s_j = jrng.rand(s_j)
        _same_u32(s_t, s_j)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_rand_masked_stream_bit_exact():
    r = np.random.default_rng(2)
    s_t, s_j = _state(_u32(2)), jnp.asarray(_u32(2))
    for _ in range(8):
        mask = r.random(N) < 0.6
        v_t, s_t = rng.rand_masked(s_t, _t(mask))
        v_j, s_j = jrng.rand_masked(s_j, jnp.asarray(mask))
        _same_u32(s_t, s_j)
        np.testing.assert_array_equal(v_t.numpy()[mask],
                                      np.asarray(v_j)[mask])


@pytest.mark.parametrize("masked", [False, True])
def test_random_direction_stream(masked):
    """The state stream is bit-exact; the direction's floats go through
    log/cos/sqrt, whose last-place rounding differs between libraries."""
    mask = np.random.default_rng(3).random(N) < 0.5
    s_t, s_j = _state(_u32(3)), jnp.asarray(_u32(3))
    for _ in range(3):
        d_t, s_t = rng.random_direction(s_t, _t(mask) if masked else None)
        d_j, s_j = jrng.random_direction(s_j,
                                         jnp.asarray(mask) if masked else None)
        _same_u32(s_t, s_j)
        keep = mask if masked else np.ones(N, bool)
        d_j = np.asarray(d_j)[keep]
        fin = np.all(np.isfinite(d_j), axis=1)    # log(0) lanes are inf/NaN
        np.testing.assert_allclose(d_t.numpy()[keep][fin], d_j[fin],
                                   rtol=1e-5, atol=2e-6)


def test_pixel_seed_per_lane_frames_bit_exact():
    """One frame count per lane, as a tensor, wrapping mod 2^32 past it
    (the JAX function takes uint32 arrays)."""
    pix = np.arange(N, dtype=np.uint32)
    frames = np.random.default_rng(4).integers(0, 2**32, N, dtype=np.uint32)
    frames[:4] = (0, 1, 2**32 - 2, 2**32 - 1)
    want = jrng.pixel_seed(jnp.asarray(pix), jnp.asarray(frames))
    _same_u32(rng.pixel_seed(_state(pix), _state(frames)), want)
    # the same counts past 2^32 (int64 lanes) and negative: mod 2^32
    wrapped = frames.astype(np.int64) + np.where(pix % 2 == 0, 2**32, -2**32)
    _same_u32(rng.pixel_seed(_state(pix), _t(wrapped)), want)
    for frame in (5, 2**32 + 5):
        _same_u32(rng.pixel_seed(_state(pix), torch.tensor(frame)),
                  jrng.pixel_seed(jnp.asarray(pix), np.uint32(frame % 2**32)))


def test_rand_u32_stream_bit_exact():
    s_t, s_j = _state(_u32(5)), jnp.asarray(_u32(5))
    for _ in range(4):
        v_t, s_t = rng.rand_u32(s_t)
        v_j, s_j = jrng.rand_u32(s_j)
        _same_u32(v_t, v_j)
        _same_u32(s_t, s_j)
        assert torch.equal(v_t, s_t)


@pytest.mark.parametrize("masked", [False, True])
def test_random_hemisphere_direction_stream(masked):
    """The new states bit for bit against the JAX function, and so the side
    of the normal each draw is flipped to wherever |n . d| is not at the
    roundoff of the direction's floats; those floats, as in
    ``test_random_direction_stream``, to rtol 1e-5.  Every finite draw lies
    on the normal's side (tests/test_rng.py:112-116), and sign 0 on the
    plane zeroes it."""
    r = np.random.default_rng(6)
    normal = r.normal(size=(N, 3)).astype(np.float32)
    normal[:8] = (0.0, 1.0, 0.0)
    mask = r.random(N) < 0.5
    m_t, m_j = (_t(mask), jnp.asarray(mask)) if masked else (None, None)
    d_t, s_t = rng.random_hemisphere_direction(_t(normal), _state(_u32(7)),
                                               m_t)
    d_j, s_j = jrng.random_hemisphere_direction(jnp.asarray(normal),
                                                jnp.asarray(_u32(7)), m_j)
    _same_u32(s_t, s_j)
    d_t, d_j = d_t.numpy(), np.asarray(d_j)
    fin = np.all(np.isfinite(d_j), axis=1)    # log(0) lanes are inf/NaN
    dot = np.sum(d_t * normal, -1)
    clear = fin & (np.abs(dot) > 1e-5 * np.linalg.norm(normal, axis=-1))
    np.testing.assert_array_equal(np.sign(dot[clear]),
                                  np.sign(np.sum(d_j * normal, -1)[clear]))
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-5, atol=2e-6)
    assert (dot[np.all(np.isfinite(d_t), axis=1)] >= 0).all()
    d, _ = rng.random_direction(_state(_u32(7))[:1])
    flat = torch.stack([d[0, 1], -d[0, 0], torch.tensor(0.0)])[None]
    d0, _ = rng.random_hemisphere_direction(flat, _state(_u32(7))[:1])
    assert float(torch.sum(flat * d)) == 0.0 and not d0.any()


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_ray_triangle_sweep_matches():
    o, d = _rays(512, 4)
    r = np.random.default_rng(5)
    a, b, c = (r.normal(size=(96, 3)).astype(np.float32) for _ in range(3))
    t_j, h_j = jix.ray_triangle_sweep(*map(jnp.asarray, (o, d, a, b, c)))
    t_t, h_t = ix.ray_triangle_sweep(*map(_t, (o, d, a, b, c)))
    h_j = np.asarray(h_j)
    # a hit flag can flip only for a ray grazing an edge within roundoff
    assert (h_t.numpy() != h_j).mean() < 1e-3
    both = h_t.numpy() & h_j
    assert both.sum() > 500
    np.testing.assert_allclose(t_t.numpy()[both], np.asarray(t_j)[both],
                               rtol=1e-6)


def test_ray_box_and_sphere_sweeps_match():
    o, d = _rays(512, 6)
    r = np.random.default_rng(7)
    lo = r.normal(size=(40, 3)).astype(np.float32)
    hi = lo + r.random((40, 3)).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    for got, want in zip(ix.ray_box_sweep(*map(_t, (o, inv, lo, hi))),
                         jix.ray_box_sweep(*map(jnp.asarray, (o, inv, lo, hi)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    cen = r.normal(size=(12, 3)).astype(np.float32)
    rad = r.random(12).astype(np.float32) + 0.1
    for got, want in zip(ix.ray_sphere_sweep(*map(_t, (o, d, cen, rad))),
                         jix.ray_sphere_sweep(*map(jnp.asarray,
                                                   (o, d, cen, rad)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_reflect_refract_normalize_match():
    o, d = _rays(2048, 8)
    n = ix.normalize(_t(o)).numpy()
    eta = np.random.default_rng(9).uniform(0.5, 2.0, 2048).astype(np.float32)
    np.testing.assert_allclose(ix.reflect(_t(d), _t(n)).numpy(),
                               np.asarray(jix.reflect(d, n)), rtol=1e-6,
                               atol=1e-6)
    (r_t, tir_t), (r_j, tir_j) = (ix.refract(_t(d), _t(n), _t(eta)),
                                  jix.refract(d, n, eta))
    np.testing.assert_array_equal(tir_t.numpy(), np.asarray(tir_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n, np.asarray(jix.normalize(o)), rtol=1e-6)


def test_ggx_sample_and_fresnel_match():
    r = np.random.default_rng(10)
    M = 4096
    _, nrm = _rays(M, 11)
    _, wo = _rays(M, 12)
    wo = np.where(np.sum(wo * nrm, 1, keepdims=True) < 0, -wo, wo)
    albedo = r.random((M, 3)).astype(np.float32)
    rough, metal, u1, u2 = (r.random(M).astype(np.float32) for _ in range(4))
    args = (nrm, wo, albedo, rough, metal, u1, u2)
    got = bsdf.ggx_sample(*map(_t, args))
    want = jbsdf.ggx_sample(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # wi = 2 (wo.h) h - wo cancels, so near-zero components of the unit
    # vector, and the grazing-angle weights computed from them, carry the
    # cos/sin roundoff as an absolute error of a few 1e-6
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    ior_a = r.uniform(1.0, 1.6, M).astype(np.float32)
    ior_b = r.uniform(1.0, 1.6, M).astype(np.float32)
    np.testing.assert_allclose(
        golden._fresnel_reflectance(*map(_t, (-wo, nrm, ior_a, ior_b))).numpy(),
        np.asarray(jgolden._fresnel_reflectance(-wo, nrm, ior_a, ior_b)),
        rtol=1e-5, atol=1e-7)


def test_single_ray_forms_match():
    """ray_triangle / ray_box / ray_sphere: ray i against primitive i."""
    o, d = _rays(2048, 13)
    r = np.random.default_rng(14)
    a, b, c = (r.normal(size=(2048, 3)).astype(np.float32) for _ in range(3))
    got = ix.ray_triangle(*map(_t, (o, d, a, b, c)))
    want = jix.ray_triangle(*map(jnp.asarray, (o, d, a, b, c)))
    hit = got[3].numpy() & np.asarray(want[3])
    assert (got[3].numpy() != np.asarray(want[3])).mean() < 1e-3
    assert hit.sum() > 50
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit],
                                   rtol=1e-5, atol=1e-6)
    lo = r.normal(size=(2048, 3)).astype(np.float32)
    hi = lo + r.random((2048, 3)).astype(np.float32)
    inv = (np.float32(1.0) / d).astype(np.float32)
    for g, w in zip(ix.ray_box(*map(_t, (o, inv, lo, hi))),
                    jix.ray_box(*map(jnp.asarray, (o, inv, lo, hi)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    rad = r.random(2048).astype(np.float32) + 0.5
    for g, w in zip(ix.ray_sphere(*map(_t, (o, d, a, rad))),
                    jix.ray_sphere(*map(jnp.asarray, (o, d, a, rad)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_bsdf_pdfs_and_evals_match():
    """The NEE-side BSDF helpers (used from the next slice on)."""
    r = np.random.default_rng(15)
    M = 4096
    _, nrm = _rays(M, 16)
    _, wo = _rays(M, 17)
    _, wi = _rays(M, 18)
    albedo = r.random((M, 3)).astype(np.float32)
    rough, metal = (r.random(M).astype(np.float32) for _ in range(2))
    pairs = [
        (bsdf.lambert_pdf(_t(nrm), _t(wi)), jbsdf.lambert_pdf(nrm, wi)),
        (bsdf.lambert_brdf_over_pi(_t(albedo)),
         jbsdf.lambert_brdf_over_pi(albedo)),
        (bsdf.ggx_pdf(*map(_t, (nrm, wo, wi, rough))),
         jbsdf.ggx_pdf(nrm, wo, wi, rough)),
        (bsdf.ggx_eval(*map(_t, (nrm, wo, wi, albedo, rough, metal))),
         jbsdf.ggx_eval(nrm, wo, wi, albedo, rough, metal)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
