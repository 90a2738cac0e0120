"""Checkpoint / resume (port of the JAX package's utils/checkpoint.py).

Format, shared with the JAX package: a directory of ``.npy`` files, one per
leaf, named by the leaf's path with ``/`` replaced by ``__``, plus
``manifest.json`` holding the sorted leaf paths (``leaves``) and free-form
metadata (``extra``).  A path joins the keys of nested dicts and the
indices of lists and tuples, as JAX's tree paths print them, so a tree of
the same structure round-trips between the two packages.  A renderer
checkpoint (``save_renderer``) holds the scene, camera and accumulation
image under the JAX package's leaf paths (``scene/materials/albedo``,
``camera/yaw``, ``image``, ...) and the frame counter, config and
``max_leaf_tris`` in ``extra``, so a render the JAX package checkpointed
resumes here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _leaf_fields(obj) -> list[str]:
    """A dataclass's fields that belong to the tree.  Its plain Python
    scalars (MeshBank.max_leaf_tris) are static metadata, not leaves, as in
    the JAX package's registered dataclasses."""
    return [f.name for f in dataclasses.fields(obj) if not isinstance(
        getattr(obj, f.name), (int, float, str, bool, type(None)))]


def _flatten_with_paths(tree, prefix=()):
    """[(path tuple, leaf)] in key order; dicts by sorted key, dataclasses
    (Scene, Camera, ...) by their leaf fields."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (str(i),))
        return out
    if dataclasses.is_dataclass(tree):
        out = []
        for k in _leaf_fields(tree):
            out += _flatten_with_paths(getattr(tree, k), prefix + (k,))
        return out
    return [(prefix, tree)]


def _as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _file(directory, key):
    return os.path.join(directory, key.replace("/", "__") + ".npy")


def save_pytree(directory: str, tree: Any, extra_meta: dict | None = None):
    """Write every leaf of ``tree`` (nested dicts, lists, tuples and tensor
    dataclasses of tensors, arrays or scalars) and the manifest."""
    os.makedirs(directory, exist_ok=True)
    leaves = {"/".join(path): _as_numpy(leaf)
              for path, leaf in _flatten_with_paths(tree)}
    for key, arr in leaves.items():
        np.save(_file(directory, key), arr)
    manifest = {"leaves": sorted(leaves), "extra": extra_meta or {}}
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_pytree(directory: str, template: Any) -> Any:
    """A tree of ``template``'s structure read from ``directory``: each leaf
    takes its template leaf's dtype, and a tensor leaf its device; a
    dataclass keeps its template's static fields.  A leaf the checkpoint
    lacks raises KeyError."""
    with open(os.path.join(directory, "manifest.json")) as f:
        stored = set(json.load(f)["leaves"])

    def load(tree, prefix):
        if isinstance(tree, dict):
            return {k: load(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(load(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        if dataclasses.is_dataclass(tree):
            return dataclasses.replace(tree, **{
                k: load(getattr(tree, k), prefix + (k,))
                for k in _leaf_fields(tree)})
        key = "/".join(prefix)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(_file(directory, key))
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr).to(device=tree.device,
                                            dtype=tree.dtype)
        return arr.astype(np.asarray(tree).dtype)

    return load(template, ())


def save_renderer(directory: str, renderer):
    """Persist a render/renderer.Renderer: scene + camera + accumulation +
    frame counter + config."""
    save_pytree(directory, {"scene": renderer.scene, "camera": renderer.camera,
                            "image": renderer.image}, extra_meta={
        "frame_count": renderer.frame_count,
        "cfg": dataclasses.asdict(renderer.cfg),
        "max_leaf_tris": renderer.scene.mesh.max_leaf_tris,
    })


def load_renderer(directory: str, renderer):
    """Restore a renderer checkpoint (this package's or the JAX package's)
    into ``renderer``, built with the same kind of scene, on its device;
    returns it."""
    from wc_path_tracer_tpu_torch.utils.config import RenderConfig

    with open(os.path.join(directory, "manifest.json")) as f:
        extra = json.load(f)["extra"]
    state = load_pytree(directory, {"scene": renderer.scene,
                                    "camera": renderer.camera,
                                    "image": renderer.image})
    scene = state["scene"]
    renderer.scene = dataclasses.replace(scene, mesh=dataclasses.replace(
        scene.mesh, max_leaf_tris=int(extra["max_leaf_tris"])))
    renderer.camera = state["camera"]
    renderer.image = state["image"]
    renderer.frame_count = int(extra["frame_count"])
    renderer.cfg = RenderConfig(**extra["cfg"])
    return renderer
