"""Nested dict / list trees of tensors — params, optimizer state,
gradients, checkpoints — walked in the reference's pytree order: a
dict's keys sorted, a list in order. A leaf's path is named as
``jax.tree_util.keystr`` names it (``['params']['first_layers'][0]
['attn']['wq']``), so the port's checkpoints carry the reference's leaf
names."""
from __future__ import annotations


def paths(tree, prefix: str = "") -> list:
    """[(keystr path, leaf)] in pytree order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves in pytree order."""
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in pytree order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
