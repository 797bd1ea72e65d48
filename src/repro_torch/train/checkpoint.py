"""Checkpoints in the reference's layout (the port's counterpart of
``repro.train.checkpoint``), so either package restores the other's.

    <dir>/step_00000100/manifest.json     {step, n_shards, n_leaves}
    <dir>/step_00000100/shard_00000.npz   flat {leaf key: array}
    <dir>/step_00000100/COMMITTED         written last: a step is visible only whole

A leaf's key joins its path with ``::`` as the reference's pytree paths
print: dict keys as they are, a NamedTuple field as ``.name``
(``opt::.m::layers_0::mixer::wq``, ``opt::.step``).  The port keeps a layer
group as a list of per-layer dicts where the reference stacks it: a
``layers_<g>`` or ``enc_layers`` list is written as one (L, ...) array a
leaf and split again on restore.  bf16 leaves are stored as f32 (npz has no
bf16) and cast back on restore.  The files are numpy's alone.

From a train mesh (``mesh`` and the tree's ``placement``) every rank takes
part in gathering each leaf whole and rank 0 writes the same single-host
layout (``n_shards`` 1); a restore slices each whole leaf to this rank's
block on any mesh, or keeps it whole without one, so a checkpoint moves
between meshes, to no mesh, and to the JAX package.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

_SEP = "::"


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # npz-safe; restore casts back losslessly
    elif t.device.type == "cpu":
        t = t.clone()  # a host copy that later steps do not touch
    return t.cpu().numpy()


def _is_layer_list(key, sub) -> bool:
    return isinstance(sub, list) and (str(key).startswith("layers_") or key == "enc_layers")


def _children(tree):
    """(key, child) of a dict or NamedTuple node."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    return list(tree.items())


def _placed(place, k):
    if place is None:
        return None
    return getattr(place, k[1:]) if isinstance(place, tuple) and hasattr(place, "_fields") else place[k]


def flatten(tree, placement=None, mesh=None) -> Dict[str, np.ndarray]:
    """The port's tree -> the reference's flat {key: host array}, layer
    groups stacked.  On a mesh (``placement``: the tree's placements) each
    leaf is gathered whole, and only rank 0 keeps the host arrays."""
    from repro_torch.bridge import gather_tree

    flat: Dict[str, np.ndarray] = {}
    keep = mesh is None or mesh.rank == 0

    def walk(prefix, node, place):
        if node is None:
            return
        if isinstance(node, dict) or (isinstance(node, tuple) and hasattr(node, "_fields")):
            for k, v in _children(node):
                key = f"{prefix}{_SEP}{k}" if prefix else str(k)
                if _is_layer_list(k, v):
                    sub = _placed(place, k)
                    layers = [flatten(layer, None if sub is None else sub[i], mesh) for i, layer in enumerate(v)]
                    for leaf in layers[0]:
                        flat[f"{key}{_SEP}{leaf}"] = np.stack([layer[leaf] for layer in layers])
                else:
                    walk(key, v, _placed(place, k))
            return
        if mesh is not None:
            node = gather_tree(node, place, mesh)
        if keep:
            flat[prefix] = _np(node)

    walk("", tree, placement)
    return flat


def unflatten_into(template, flat: Dict[str, Any], placement=None, mesh=None):
    """The reference's flat arrays -> a tree shaped like ``template``, each
    leaf on the template leaf's device in its dtype.  On a mesh
    (``placement``: the template's placements) each whole array is cut to
    this rank's block first."""

    def leaf(key, t, arr, place):
        arr = torch.from_numpy(np.array(arr, copy=True))
        if mesh is not None:
            arr = place.local(arr, mesh)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} vs {tuple(t.shape)}")
        return arr.to(device=t.device, dtype=t.dtype)

    def get(key):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        return flat[key]

    def walk(prefix, node, place, index=None):
        if node is None:
            return None
        if isinstance(node, dict) or (isinstance(node, tuple) and hasattr(node, "_fields")):
            out = {}
            for k, v in _children(node):
                key = f"{prefix}{_SEP}{k}" if prefix else str(k)
                sub = _placed(place, k)
                if index is None and _is_layer_list(k, v):
                    out[k] = [walk(key, layer, None if sub is None else sub[i], i) for i, layer in enumerate(v)]
                else:
                    out[k] = walk(key, v, sub, index)
            if isinstance(node, tuple):
                return type(node)(*(out[f".{f}"] for f in node._fields))
            return out
        arr = get(prefix)
        return leaf(prefix, node, arr if index is None else np.asarray(arr)[index], place)

    return walk("", template, placement)


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3, mesh=None, placement=None) -> str:
    """Atomic save of a tree of tensors; prunes to the newest ``keep``
    checkpoints.  On a mesh every rank calls it and rank 0 writes."""
    flat = flatten(tree, placement, mesh)
    final = os.path.join(directory, f"step_{step:08d}")
    if mesh is None or mesh.rank == 0:
        final = _write(directory, step, flat, keep)
    _barrier(mesh)
    return final


def _barrier(mesh):
    if mesh is not None and mesh.groups:
        import torch.distributed as dist

        dist.barrier()


def _write(directory: str, step: int, flat: Dict[str, np.ndarray], keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "shard_00000.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_shards": 1, "n_leaves": len(flat)}, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int):
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _committed_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(os.path.join(directory, name, "COMMITTED")):
            out.append(int(name[5:]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template, step: Optional[int] = None, *, mesh=None,
                       placement=None) -> Tuple[Any, int]:
    """Restore the newest (or ``step``'s) checkpoint into a tree shaped like
    ``template`` -> (tree, step); on a mesh ``template`` holds this rank's
    shards, placed as ``placement`` says, whatever mesh wrote it."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, Any] = {}
    for i in range(manifest["n_shards"]):
        with np.load(os.path.join(d, f"shard_{i:05d}.npz")) as z:
            flat.update({k: z[k] for k in z.files})
    return unflatten_into(template, flat, placement, mesh), step


class CheckpointManager:
    """Background-thread checkpoint writer, at most one save in flight:
    ``maybe_save`` copies the tree to host arrays first, so training may
    go on changing its tensors while the thread writes.  A save that
    failed raises from the next ``wait`` (or ``maybe_save``).  On a mesh
    every rank calls it: the leaves are gathered whole, rank 0 writes, and
    ``wait`` holds every rank until the write is committed."""

    def __init__(self, directory: str, keep: int = 3, every: int = 50, *, mesh=None, placement=None):
        self.directory = directory
        self.keep = keep
        self.every = every
        self.mesh = mesh
        self.placement = placement
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _save(self, step: int, host: Dict[str, np.ndarray]):
        try:
            _write(self.directory, step, host, self.keep)
        except Exception as e:  # handed to the training thread by wait()
            self._error = e

    def maybe_save(self, step: int, tree, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        host = flatten(tree, self.placement, self.mesh)  # device -> host copy now
        if self.mesh is None or self.mesh.rank == 0:
            self._thread = threading.Thread(target=self._save, args=(step, host), daemon=True)
            self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.mesh)
        if self._error is not None:
            error, self._error = self._error, None
            raise error
