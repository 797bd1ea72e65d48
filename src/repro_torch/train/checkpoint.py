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


def flatten(tree) -> Dict[str, np.ndarray]:
    """The port's tree -> the reference's flat {key: host array}, layer
    groups stacked."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if node is None:
            return
        if isinstance(node, dict) or (isinstance(node, tuple) and hasattr(node, "_fields")):
            for k, v in _children(node):
                key = f"{prefix}{_SEP}{k}" if prefix else str(k)
                if _is_layer_list(k, v):
                    layers = [flatten(layer) for layer in v]
                    for leaf in layers[0]:
                        flat[f"{key}{_SEP}{leaf}"] = np.stack([layer[leaf] for layer in layers])
                else:
                    walk(key, v)
            return
        flat[prefix] = _np(node)

    walk("", tree)
    return flat


def unflatten_into(template, flat: Dict[str, Any]):
    """The reference's flat arrays -> a tree shaped like ``template``, each
    leaf on the template leaf's device in its dtype."""

    def leaf(key, t, arr):
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(t.shape)}")
        return torch.from_numpy(np.array(arr, copy=True)).to(device=t.device, dtype=t.dtype)

    def get(key):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        return flat[key]

    def walk(prefix, node, index=None):
        if node is None:
            return None
        if isinstance(node, dict) or (isinstance(node, tuple) and hasattr(node, "_fields")):
            out = {}
            for k, v in _children(node):
                key = f"{prefix}{_SEP}{k}" if prefix else str(k)
                if index is None and _is_layer_list(k, v):
                    out[k] = [walk(key, layer, i) for i, layer in enumerate(v)]
                else:
                    out[k] = walk(key, v, index)
            if isinstance(node, tuple):
                return type(node)(*(out[f".{f}"] for f in node._fields))
            return out
        arr = get(prefix)
        return leaf(prefix, node, arr if index is None else np.asarray(arr)[index])

    return walk("", template)


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic save of a tree of tensors; prunes to the newest ``keep``
    checkpoints."""
    return _write(directory, step, flatten(tree), keep)


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


def restore_checkpoint(directory: str, template, step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore the newest (or ``step``'s) checkpoint into a tree shaped like
    ``template`` -> (tree, step)."""
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
    return unflatten_into(template, flat), step


class CheckpointManager:
    """Background-thread checkpoint writer, at most one save in flight:
    ``maybe_save`` copies the tree to host arrays first, so training may
    go on changing its tensors while the thread writes.  A save that
    failed raises from the next ``wait`` (or ``maybe_save``)."""

    def __init__(self, directory: str, keep: int = 3, every: int = 50):
        self.directory = directory
        self.keep = keep
        self.every = every
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
        host = flatten(tree)  # device -> host copy now
        self._thread = threading.Thread(target=self._save, args=(step, host), daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
