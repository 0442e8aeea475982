"""Nested parameter trees addressed by JAX ``keystr`` paths.

Parameters are plain nested dicts and lists of tensors (or packed MX
containers). Every leaf is named by the path JAX's ``keystr`` gives it,
e.g. ``"['blocks'][0]['attn']['wq']"``, so anchor checkpoints written by
either package map leaf-for-leaf onto the other's trees. Dict keys are
visited in sorted order, as JAX flattens dicts.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def flatten_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf), ...] in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_paths(tree[k], f"{prefix}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten_paths(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def unflatten_paths(flat: Dict[str, Any]):
    """Rebuild the nested dict/list tree from ``{keystr path: leaf}``."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = [(m.group(1), m.group(2)) for m in _PART.finditer(path)]
        if "".join(m.group(0) for m in _PART.finditer(path)) != path \
                or not parts:
            raise ValueError(f"not a keystr path of dict/list keys: {path!r}")
        node = root
        for key, idx in parts[:-1]:
            node = node.setdefault(key if key is not None else int(idx), {})
        key, idx = parts[-1]
        node[key if key is not None else int(idx)] = leaf
    return _lists(root)


def _lists(node):
    """Dicts keyed by 0..n-1 ints become lists (JAX sequence keys)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sparse sequence indices {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``),
    keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
