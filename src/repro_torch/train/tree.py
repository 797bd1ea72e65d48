"""Walking the port's parameter trees: nested dicts, lists (the per-layer
groups) and NamedTuples (``OptState``) of tensors."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in a fixed order: dict insertion order, list
    and tuple order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)
