"""Nested dicts, lists and tuples of tensors (parameter, optimizer-state
and cache trees), walked in one order: dict insertion order, then list
order.

`flatten_with_paths` names each leaf as the JAX package's checkpoints do
(`jax.tree_util.tree_flatten_with_path`, joined with "/": a dict key as
itself, a list or tuple index as its number), so "0/slots/1/attn/wq"
means the same leaf in both packages.
"""
from __future__ import annotations

import torch


def leaves(tree):
    """The tensors of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def map_tree(fn, tree):
    """The same nesting with fn(leaf) in place of each tensor."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def map_with_path(fn, tree, path: tuple = ()):
    """The same nesting with fn(path, leaf) in place of each tensor;
    `path` is the tuple of names from the root (dict keys as they are,
    list / tuple indices as str), as `flatten_with_paths` joins them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def zip_leaves(tree, *others):
    """(leaf, node of each other tree at the leaf's place), in order.  An
    other tree may hold a subtree where `tree` holds a tensor (adafactor's
    per-leaf {"vr", "vc"} state)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from zip_leaves(v, *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from zip_leaves(v, *(o[i] for o in others))
    else:
        yield (tree,) + others


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """{"a/0/b": tensor, ...}: each leaf under its path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                      else str(k)))
    return out


def rebuild(tree, values):
    """The same nesting with the next of `values` (an iterable, in leaf
    order) in place of each tensor."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)
