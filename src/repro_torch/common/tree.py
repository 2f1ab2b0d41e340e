"""Tree utilities shared across the port (counterpart of ``repro.common.tree``).

Parameters, optimizer state and train state are plain nested dicts and
lists of tensors, the layout ``bridge.py`` carries across from the JAX
reference.  A tree's leaves are visited in JAX's order: dict keys
sorted, lists and tuples in index order; ``None`` is an empty subtree.
Everything else (a tensor, a numpy array, a Python number) is a leaf.

:func:`tree_map` walks the structure of its first tree and hands each
leaf, with the subtrees at the same place in the other trees, to ``fn``
— JAX's ``flatten_up_to``, so a param tree can be mapped beside an
optimizer state whose "leaf" is a dict (Adafactor's ``{r, c}``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

Tree = Any


def _children(tree):
    """``[(key, child)]`` of a dict or list node in leaf order, else None."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves(tree: Tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, c in kids for leaf in tree_leaves(c)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn(leaf, *others)`` over the structure of ``tree``; each other
    tree is indexed alongside, and what it holds at a leaf of ``tree``
    (a leaf or a whole subtree) is passed as is."""
    return path_map(lambda _p, leaf, *o: fn(leaf, *o), tree, *rest)


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def param_count(tree: Tree) -> int:
    """Total number of scalar parameters in a tree."""
    return int(sum(int(np.prod(leaf.shape)) if hasattr(leaf, "shape") else 1
                   for leaf in tree_leaves(tree)))


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def param_bytes(tree: Tree) -> int:
    """Total bytes occupied by a tree (using each leaf's dtype)."""
    return int(sum(int(np.prod(leaf.shape)) * _itemsize(leaf)
                   for leaf in tree_leaves(tree) if hasattr(leaf, "shape")))


def tree_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """Cast every floating-point tensor leaf of a tree to ``dtype``."""
    return tree_map(
        lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
        and x.is_floating_point() else x, tree)


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over all leaves, summed in fp32 (used for grad clipping).

    A 0-d fp32 tensor on the leaves' device; nothing is read back to the
    host.  Each leaf's norm is taken by ``vector_norm`` in fp32, which
    needs no fp32 copy of a bf16 leaf and no squared temporary of a
    large one (the ``fm`` table's gradient is 3.6 GB).
    """
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = torch.stack([torch.linalg.vector_norm(leaf, dtype=torch.float32)
                         for leaf in leaves])
    return norms.square().sum().sqrt()


def path_str(path) -> str:
    """Render a key path (dict keys and list indices) as ``'a/b/0/c'``."""
    return "/".join(str(p) for p in path)


def path_map(fn: Callable, tree: Tree, *rest: Tree, _path=()) -> Tree:
    """Map ``fn(path_string, leaf, *others) -> leaf`` over a tree; the
    other trees are indexed alongside as in :func:`tree_map`."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path_str(_path), tree, *rest)
    out = {k: path_map(fn, c, *(r[k] for r in rest), _path=_path + (k,))
           for k, c in kids}
    if isinstance(tree, dict):
        return {k: out[k] for k in tree}           # keep the caller's order
    return type(tree)(out[i] for i in range(len(tree)))


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)
