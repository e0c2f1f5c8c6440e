"""Parameter updates by name — counterpart of ``aimet_tpu/utils/pytree.py``.

The JAX package addresses a leaf of its parameter tree by its key string;
the port's parameters are a flat ``Dict[str, Tensor]`` keyed by qualified
module name, so a path is a key and the flatten order is the dict's order.
``set_leaves`` returns a new dict and never writes into the caller's
tensors: the algorithms rely on that, as the JAX tree is immutable.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping


def leaf_index_map(tree: Mapping[str, Any]) -> Dict[str, int]:
    """Map each name to its index in the dict's order."""
    return {k: i for i, k in enumerate(tree)}


def get_leaf(tree: Mapping[str, Any], path: str):
    if path not in tree:
        raise KeyError(path)
    return tree[path]


def set_leaves(tree: Mapping[str, Any], updates: Mapping[str, Any]
               ) -> Dict[str, Any]:
    """A copy of ``tree`` with the entries at ``updates``' names replaced
    (an unknown name raises ``KeyError``)."""
    out = dict(tree)
    for path, val in updates.items():
        if path not in out:
            raise KeyError(path)
        out[path] = val
    return out
