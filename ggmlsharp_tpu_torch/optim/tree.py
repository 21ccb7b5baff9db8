"""Parameter trees: nested dicts, lists and tuples of tensors (None is an
empty subtree), walked in the JAX package's pytree order (dict keys sorted)."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *[r[i] for r in rest])
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (tree_leaves
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    return build(tree)
