"""Nested parameter trees and their flat ``.npz`` checkpoint.

Counterpart of the JAX package's ``save_params`` / ``load_params``
(``xrdslam_tpu/engine/dpvo_train.py``): a nested tree of dicts and lists
is saved as one array per leaf under its ``/``-joined path (list items by
their index) and loaded back into the same tree, leaves as numpy arrays,
so either package loads the other's file. ``flatten_tree`` and
``listify`` are the two halves of that mapping; the models' tree
converters (``models/vonet``, ``utils/torch_convert``) use them too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested dict / list tree -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save_params(path: str, params: Any) -> None:
    """Save a nested tree whose leaves are numpy arrays or tensors."""
    flat = {}
    for key, leaf in flatten_tree(params).items():
        if hasattr(leaf, "detach"):  # a tensor
            leaf = leaf.detach().cpu().numpy()
        flat[key] = np.asarray(leaf)
    np.savez_compressed(path, **flat)


def listify(node: Any) -> Any:
    """Turn dicts keyed "0", "1", ... back into lists, recursively."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [listify(node[str(i)]) for i in range(len(keys))]
    return {k: listify(v) for k, v in node.items()}


def load_params(path: str) -> Dict[str, Any]:
    """The inverse of ``save_params``: the nested tree, leaves as numpy arrays."""
    root: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return listify(root)
