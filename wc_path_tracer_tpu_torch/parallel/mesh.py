"""Process groups for data-parallel rendering and training (port of the JAX
package's parallel/mesh.py).

The JAX package lays a 1-D ``dp`` device mesh over every chip and lets
``shard_map`` place the row bands.  Here each rank is one process with one
device, joined by a ``torch.distributed`` process group: rows are split
into one band per rank, the scene is replicated, and the collectives are an
``all_gather`` of rendered bands and an ``all_reduce`` of gradients.

The backend is the caller's choice, never guessed: "nccl" when each rank
has a card of its own, "gloo" otherwise (CPU tensors, or several ranks
sharing one card, which NCCL refuses).  A ``group`` of None everywhere in
``parallel/`` means this process alone (world size 1).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize_distributed(backend: str, init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None):
    """Join the process group of ``world_size`` ranks as ``rank`` through
    ``init_method`` (e.g. ``tcp://localhost:29500``; None reads the
    ``MASTER_ADDR``/``MASTER_PORT`` environment, as ``torchrun`` sets it).
    Returns the world group, or None (nothing done) for a world size of 1
    or None, as the JAX package's ``initialize_distributed``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if world_size is None or world_size <= 1:
        return None
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def world_size(group=None) -> int:
    """The number of ranks in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def replicate_scene(scene, group=None, src: int = 0):
    """A copy of ``scene`` (the same capacities on every rank) holding
    global rank ``src``'s tensors on every rank of ``group``: the analog of
    the reference uploading scene buffers to its one GPU
    (BufferManager.jai:52)."""
    if group is None:
        return scene

    def bcast(part):
        out = {}
        for f in dataclasses.fields(part):
            t = getattr(part, f.name)
            if isinstance(t, torch.Tensor):
                t = t.clone()
                dist.broadcast(t, src=src, group=group)
                out[f.name] = t
        return dataclasses.replace(part, **out)

    return dataclasses.replace(scene, materials=bcast(scene.materials),
                               spheres=bcast(scene.spheres),
                               mesh=bcast(scene.mesh))
