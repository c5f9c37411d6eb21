"""Nested dicts of tensors (parameters, optimizer state, batches) as the
reference's pytrees: leaves in sorted-key order, as ``jax.tree`` flattens
a dict, and paths "a/b/c"."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def is_leaf(x) -> bool:
    return not isinstance(x, dict)


def flatten(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree``'s order: keys sorted at every
    level; a leaf at the root has the path ""."""
    if is_leaf(tree):
        return [("", tree)]
    out = []
    for k in sorted(tree):
        for path, leaf in flatten(tree[k]):
            out.append((f"{k}/{path}" if path else str(k), leaf))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def leaves_up_to(template, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``template`` (whose
    structure is a prefix of ``tree``'s), in sorted-key order: one
    Adafactor state dict per parameter."""
    if is_leaf(template):
        return [tree]
    return [x for k in sorted(template)
            for x in leaves_up_to(template[k], tree[k])]


def unflatten_like(template, values: list):
    """``values`` (in ``leaves(template)``'s order) in the template's
    structure."""
    it = iter(values)

    def build(node):
        if is_leaf(node):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}

    out = build(template)
    rest = list(it)
    if rest:
        raise ValueError(f"unflatten_like: {len(rest)} values left over")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (each with ``tree``'s structure)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def to_device(tree, device) -> Dict[str, Any]:
    return tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t,
                    tree)
