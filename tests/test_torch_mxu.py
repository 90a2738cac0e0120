"""Port vs JAX package: the plane-form ("mxu") cluster sweep.

The JAX sweep runs its Pallas kernel in interpret mode; the port runs the
kernel's plain twin (CPU tensors).  Scene ``bunny_like_scene(2)`` (342
triangle slots, 3 clusters), its 32 x 32 primary rays and a 2-bounce
frame.

Tolerances: the plane-form slab entries within rtol 1e-6, with an absolute
floor of 1e-6 of the table's largest entry for entries that cancel (XLA-CPU
contracts the cross products' multiply-adds into FMAs, the port rounds
every product); AABBs and materials bit-exact; hit masks and materials
equal, ``t`` within rtol 1e-5, slot ids equal except on exact ``t`` ties;
frames within atol 2e-5 of the MT frame (the JAX package's own criterion,
tests/test_sweep.py) and, against the JAX frame, test_torch_render.py's
outlier criterion.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.kernels import cluster as jcluster
from wc_path_tracer_tpu.models import procedural as jproc
from wc_path_tracer_tpu.render import sweep as jsweep
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import cluster, launches
from wc_path_tracer_tpu_torch.models import procedural
from wc_path_tracer_tpu_torch.render import sweep
from wc_path_tracer_tpu_torch.scene import camera

from test_torch_render import _assert_images_close

torch.set_num_threads(2)

W = H = 32
KINF = cluster.KINF
FRAME_CFG = dict(width=W, height=H, samples=1, max_bounces=2,
                 cluster_kernel="mxu")


@functools.lru_cache(maxsize=None)
def _case():
    jscene, jcam = jproc.bunny_like_scene(2)
    tscene, _ = procedural.bunny_like_scene(2, device="cpu")
    jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                    np.asarray(jm.inverse_view),
                                    np.asarray(jm.position), "cpu")
    d = np.asarray(jcamera.primary_ray_directions(jm, W, H)).reshape(-1, 3)
    o = np.broadcast_to(np.asarray(jm.position), d.shape).copy()
    jt = jcluster.build_cluster_tables_mxu(jscene.mesh)
    tt = cluster.build_cluster_tables_mxu(tscene.mesh)
    return dict(jscene=jscene, jm=jm, tscene=tscene, tm=tm, o=o, d=d,
                t_init=np.full(W * H, KINF, np.float32), jt=jt, tt=tt)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_mxu_tables_match_jax():
    c = _case()
    trisW, cmin, cmax, mat = (x.numpy() for x in c["tt"])
    jW, jmin, jmax, jmat = (np.asarray(x) for x in c["jt"])
    assert trisW.shape == (3 * cluster.MXU_ROWS,
                           cluster.MXU_FIELDS * cluster.CLUSTER_TRIS)
    np.testing.assert_allclose(trisW, jW, rtol=1e-6,
                               atol=1e-6 * np.abs(jW).max())
    for got, want in ((cmin, jmin), (cmax, jmax), (mat, jmat)):
        np.testing.assert_array_equal(got, want)
    # the AABBs are the MT tables'; dead slots (342..383) are all zero
    for got, want in zip((cmin, cmax),
                         cluster.build_cluster_tables(c["tscene"].mesh)[1:]):
        np.testing.assert_array_equal(got, want.numpy())
    dead = trisW.reshape(3, 8, 6, 128)[2, :, :, 342 - 256:]
    assert not dead.any()


def _assert_mxu_payload_matches_jax(ray_block):
    c = _case()
    o, d, t0 = c["o"], c["d"], c["t_init"]
    want = np.asarray(jcluster.cluster_sweep(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0), *c["jt"][:3],
        interpret=True, variant="mxu", mat_tbl=c["jt"][3],
        ray_block=ray_block))
    tw, cmin, cmax, mat = c["tt"]
    got = cluster.cluster_sweep(_t(o), _t(d), _t(t0), tw, cmin, cmax,
                                ray_block=ray_block, variant="mxu",
                                mat_tbl=mat).numpy()
    hit = want[:, 11] >= 0
    assert hit.sum() > 200
    np.testing.assert_array_equal(got[:, 11] >= 0, hit)
    np.testing.assert_array_equal(got[hit, 10], want[hit, 10])
    np.testing.assert_allclose(got[hit, 0], want[hit, 0], rtol=1e-5)
    np.testing.assert_array_equal(got[~hit, 0], want[~hit, 0])
    differ = got[:, 11] != want[:, 11]
    assert (got[differ, 0] == want[differ, 0]).all()    # exact ties only
    # vertex and pad columns are zero, as in the JAX plane-form kernel
    np.testing.assert_array_equal(got[:, 1:10], want[:, 1:10])
    np.testing.assert_array_equal(got[:, 12:], 0.0)


def test_mxu_payload_matches_jax():
    _assert_mxu_payload_matches_jax(cluster.RAY_BLOCK)


def test_mxu_payload_matches_jax_at_ray_block_8192():
    """A ray block above what a thread block cluster holds one ray per
    thread (the kernel's multi-pass form): the same agreement."""
    _assert_mxu_payload_matches_jax(8192)


def test_mxu_form_check_passes_port_and_jax_tables():
    """Tables built by the port, and tables bridged from the JAX package,
    have the plane form the CUDA kernel relies on; a table that passed is
    not checked again until it is edited in place."""
    c = _case()
    cluster.check_mxu_form(c["tt"][0])
    cluster.check_mxu_form(_t(c["jt"][0]))
    tw = cluster.build_cluster_tables_mxu(
        procedural.bunny_like_scene(3, device="cpu")[0].mesh)[0]
    cluster.check_mxu_form(tw)
    assert tw._mxu_form_version == tw._version
    tw[0, 0] = 1.0            # row 0 of field Q: structural zero
    with pytest.raises(ValueError, match="plane form"):
        cluster.check_mxu_form(tw)


@pytest.mark.parametrize("row, field", [(0, 0), (2, 2), (6, 4), (7, 0),
                                        (4, 1), (7, 3), (5, 5)])
def test_mxu_form_check_rejects_a_structural_entry(row, field):
    """One non-zero structural entry (a d-field outside rows 3-5, an
    o-field in rows 3-5 or 7) in one slot of one cluster is refused, by the
    check and by the kernel wrapper on the CPU too."""
    c = _case()
    tw = c["tt"][0].clone()
    tw.view(-1, cluster.MXU_ROWS, cluster.MXU_FIELDS,
            cluster.CLUSTER_TRIS)[1, row, field, 77] = 0.5
    with pytest.raises(ValueError, match="plane form"):
        cluster.check_mxu_form(tw)
    nact = torch.zeros(1, dtype=torch.int32)
    rays = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="plane form"):
        cluster.cluster_sweep_mxu_kernel(
            nact, torch.zeros((1, 3), dtype=torch.int32), torch.zeros((1, 3)),
            rays, rays, tw, c["tt"][3])


def test_mxu_form_check_rejects_a_copy_that_differs():
    """n, au and av appear twice in a slab (d-field rows 3-5, o-field rows
    0-2); the kernel reads one copy, so the two must be equal."""
    c = _case()
    tw = c["tt"][0].clone()
    W = tw.view(-1, cluster.MXU_ROWS, cluster.MXU_FIELDS, cluster.CLUSTER_TRIS)
    W[2, 1, 3, 5] = W[2, 1, 3, 5] + 1.0       # Au's copy of au.y
    with pytest.raises(ValueError, match="plane form"):
        cluster.check_mxu_form(tw)


def test_mxu_payload_matches_mt():
    c = _case()
    o, d, t0 = (_t(c[k]) for k in ("o", "d", "t_init"))
    mt = cluster.cluster_sweep(o, d, t0,
                               *cluster.build_cluster_tables(c["tscene"].mesh))
    tw, cmin, cmax, mat = c["tt"]
    mx = cluster.cluster_sweep(o, d, t0, tw, cmin, cmax, variant="mxu",
                               mat_tbl=mat)
    hit = (mt[:, 11] >= 0).numpy()
    np.testing.assert_array_equal((mx[:, 11] >= 0).numpy(), hit)
    np.testing.assert_array_equal(mx[hit, 10].numpy(), mt[hit, 10].numpy())
    np.testing.assert_allclose(mx[hit, 0].numpy(), mt[hit, 0].numpy(),
                               rtol=1e-5)


def test_mxu_wrapper_twin_visits_and_early_exit():
    """The wrapper runs the plain twin on CPU tensors (no launch counted);
    the twin reports visits, and stopping early changes no winner.
    ``bunny_like_scene(3)`` (11 clusters) and coherent camera-like rays that
    all hit the mesh, so blocks can stop before their last cluster."""
    tscene, _ = procedural.bunny_like_scene(3, device="cpu")
    tw, cmin, cmax, mat = cluster.build_cluster_tables_mxu(tscene.mesh)
    u, v = np.meshgrid(np.linspace(-0.2, 0.2, 64), np.linspace(-0.2, 0.2, 64))
    d = np.stack([u, v, -np.ones_like(u)], -1).reshape(-1, 3)
    d = _t((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    o = torch.tensor([[0.0, 1.0, 3.0]]).expand(4096, 3).contiguous()
    t0 = torch.full((4096,), KINF)
    seen = {}

    def block_fn(nact, clist, bt0, rays, prev, trisW, mat_tbl):
        visits = torch.zeros(nact.shape, dtype=torch.int32)
        out = cluster.cluster_sweep_mxu_kernel(nact, clist, bt0, rays, prev,
                                               trisW, mat_tbl, visits)
        full = cluster.cluster_sweep_mxu_plain(
            nact, clist, torch.full_like(bt0, -KINF), rays, prev, trisW,
            mat_tbl)
        seen.update(nact=nact, visits=visits, out=out, full=full)
        return out

    before = launches.read_counts()["B2"]
    cluster.cluster_sweep(o, d, t0, tw, cmin, cmax, block_fn=block_fn,
                          variant="mxu", mat_tbl=mat)
    assert launches.read_counts()["B2"] == before
    assert torch.all(seen["visits"] <= seen["nact"])
    assert torch.all(seen["visits"] >= (seen["nact"] > 0).int())
    assert int(seen["visits"].sum()) < int(seen["nact"].sum())
    assert torch.equal(seen["out"], seen["full"])


def test_cluster_sweep_variant_arguments():
    c = _case()
    o, d, t0 = (_t(c[k][:8]) for k in ("o", "d", "t_init"))
    tw, cmin, cmax, _ = c["tt"]
    with pytest.raises(ValueError, match="mat_tbl"):
        cluster.cluster_sweep(o, d, t0, tw, cmin, cmax, variant="mxu")
    with pytest.raises(ValueError, match="variant"):
        cluster.cluster_sweep(o, d, t0, tw, cmin, cmax, variant="bf16")
    assert len(sweep.build_tables(c["tscene"].mesh,
                                  RenderConfig(cluster_kernel="mxu"))) == 4
    assert len(sweep.build_tables(c["tscene"].mesh, RenderConfig())) == 3


@functools.lru_cache(maxsize=None)
def _frame(kernel):
    c = _case()
    cfg = RenderConfig(**dict(FRAME_CFG, cluster_kernel=kernel))
    return sweep.render_frame(c["tscene"], c["tm"], cfg, 1).numpy()


def test_mxu_frame_matches_mt_frame():
    got, mt = _frame("mxu"), _frame("mt")
    assert np.isfinite(got).all() and got.std() > 0.01
    np.testing.assert_allclose(got, mt, atol=2e-5)


def test_mxu_frame_matches_jax():
    c = _case()
    want = np.asarray(jax.jit(jsweep.render_frame, static_argnames="cfg")(
        c["jscene"], c["jm"], JConfig(**FRAME_CFG), 1))
    _assert_images_close(_frame("mxu"), want)


def test_mxu_ray_sort_modes_identical():
    c = _case()
    imgs = [sweep.render_frame(c["tscene"], c["tm"], RenderConfig(
        **dict(FRAME_CFG, ray_sort=mode)), 1) for mode in ("static", "off")]
    for img in imgs:
        assert np.array_equal(img.numpy(), _frame("mxu"))
