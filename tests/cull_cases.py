"""Seeded queries for the cluster sweep's cull and per-block order (C1 and
its twin ``cluster.cull_order_plain``), shared by the CPU tests and the
card tests.  Plain PyTorch and numpy: nothing here imports JAX.

``cull_case(name, device)`` -> (origin, direction, t_init, cmin, cmax,
ray_block, tris): the boxes come from the triangles' tables, so B1 can
sweep the same query.
"""

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import cluster
from wc_path_tracer_tpu_torch.models.procedural import (signed_zero_query,
                                                         tie_heavy_query)

KINF = cluster.KINF


def _boxed_query(o, d, t, lo, hi, ray_block, device, seed, dead=()):
    """(origin, direction, t_init, cmin, cmax, ray_block, tris) with one
    cluster per box: its 128 slots hold triangles on the box's 1/4 grid,
    the first two from ``lo`` to ``hi`` through opposite corners, so the
    cluster's AABB is the box; the clusters in ``dead`` hold no live slot
    and get the all-dead box (+KINF, -KINF)."""
    r = np.random.default_rng(seed)
    C, T = lo.shape[0], cluster.CLUSTER_TRIS
    size = np.round((hi - lo) * 4).astype(int)

    def inside():
        return lo[:, None] + r.integers(0, size[:, None] + 1, (C, T, 3)) / 4

    a, b, c = inside(), inside(), inside()
    a[:, :2], c[:, :2] = lo[:, None], hi[:, None]
    b[:, 0] = np.stack([hi[:, 0], lo[:, 1], lo[:, 2]], axis=1)
    b[:, 1] = np.stack([lo[:, 0], hi[:, 1], hi[:, 2]], axis=1)
    live = np.ones((C, T), bool)
    live[list(dead)] = False

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    coords = [f32(np.where(live[..., None], x, 0.0).reshape(C * T, 3))
              for x in (a, b, c)]
    tris, cmin, cmax = cluster.tables_from_coords(
        *coords, f32(np.arange(C * T) % 97),
        torch.tensor(live.reshape(-1), device=device), C)
    return (f32(o), f32(d), f32(t), cmin, cmax, ray_block, tris)


def grid_query(n_rays, clusters, seed, ray_block=512, dead=(),
               disabled=0.0, device="cpu"):
    """A seeded cull query on a 1/4 grid.  Boxes of 1 to 4 quarters a side;
    origins on the grid, so many lie on a face; direction components from
    {+-1, +-0.5, +-0.0}, so rays run along the axes, with both signs of
    zero, and slab terms of 0 x inf (NaN: no entry) occur; entries tie
    across clusters.  The clusters in ``dead`` are all-dead; a
    ``disabled`` share of the lanes get the bound -KINF, the others KINF
    or a finite bound."""
    r = np.random.default_rng(seed)
    lo = r.integers(-8, 8, (clusters, 3)) / 4.0
    hi = lo + r.integers(1, 5, (clusters, 3)) / 4.0
    o = r.integers(-10, 11, (n_rays, 3)) / 4.0
    d = r.choice([-1.0, -0.5, -0.0, 0.0, 0.5, 1.0], (n_rays, 3))
    d[~d.any(axis=1), 0] = 1.0
    t = np.where(r.random(n_rays) < 0.5, KINF,
                 r.integers(1, 16, n_rays) / 4.0)
    t[r.random(n_rays) < disabled] = -KINF
    return _boxed_query(o, d, t, lo, hi, ray_block, device, seed, dead)


def signed_zero_entries(device="cpu"):
    """Blocks whose entry distances are +0.0 on some clusters and -0.0 on
    others, interleaved: 8 copies each of the box x in [0, 1] (entered at
    +0.0 by the rays leaving x = 0 along +x) and of x in [-1, 0] at other
    y (entered at -0.0 by the rays leaving x = 0 along -x)."""
    C, n = 16, 1024
    lo = np.array([[0.0, 0.0, -1.0] if c % 2 == 0 else [-1.0, -2.0, -1.0]
                   for c in range(C)])
    hi = lo + np.array([1.0, 1.0, 2.0])
    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    o = np.stack([np.zeros(n), np.where(sign > 0, 0.5, -1.5),
                  np.linspace(-0.5, 0.5, n)], axis=1)
    d = np.stack([sign, np.zeros(n), np.zeros(n)], axis=1)
    t = np.full(n, KINF)
    return _boxed_query(o, d, t, lo, hi, 256, device, 0)


def _reorder(q, ray_block):
    o, d, t, tris, cmin, cmax = q
    return (o, d, t, cmin, cmax, ray_block, tris)


CULL_CASES = {
    "grid": lambda dev: grid_query(2048, 24, 1, device=dev),
    "dead-clusters": lambda dev: grid_query(2048, 24, 2, dead=(0, 5, 6, 23),
                                            device=dev),
    "disabled-lanes": lambda dev: grid_query(2048, 24, 3, disabled=0.3,
                                             device=dev),
    "ragged": lambda dev: grid_query(1000, 24, 4, ray_block=128, device=dev),
    "one-cluster": lambda dev: grid_query(1000, 1, 5, device=dev),
    "161-clusters": lambda dev: grid_query(1024, 161, 6, ray_block=256,
                                           dead=(160,), device=dev),
    "signed-zero-entries": signed_zero_entries,
    "tie-heavy": lambda dev: _reorder(
        tie_heavy_query(2048, 12, seed=3, device=dev), 512),
    "signed-zero": lambda dev: _reorder(
        signed_zero_query(2048, 6, seed=5, device=dev, variant="mt"), 256),
}


def cull_case(name, device="cpu"):
    """The seeded query ``name`` of CULL_CASES on ``device``."""
    return CULL_CASES[name](device)
