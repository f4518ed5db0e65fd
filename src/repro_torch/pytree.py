"""Nested containers of tensors in the JAX package's tree order: a dict
by sorted key, a list or tuple by index, anything else a leaf.  The
AdamW state, the global norm's sum and the checkpoint's keys follow this
order, as ``jax.tree`` flattens the JAX package's trees."""
from __future__ import annotations


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves_with_path(tree, prefix=()):
    """[(path, leaf)] in tree order; a path is a tuple of dict keys and
    sequence indices."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in leaves_with_path(x, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path) -> str:
    """The checkpoint key of a path: its entries joined by "/" (JAX's
    ``checkpoint._flatten``)."""
    return "/".join(str(p) for p in path)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``, in tree order, and the matching
    leaves of ``rest``, which have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, values):
    """``tree``'s structure with ``values`` (in tree order) at its
    leaves."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)
