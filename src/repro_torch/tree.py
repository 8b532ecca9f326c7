"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Leaves are visited in sorted key order at every level, which is the order
``jax.tree.leaves`` gives a dict, so a flattened port state lines up column
for column with the JAX package's ``flatten_stacked``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Path = Tuple[str, ...]


def items(tree: dict, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order."""
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            yield from items(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def map(fn: Callable, tree: dict, *rest: dict) -> dict:  # noqa: A001
    """``fn`` applied leafwise over trees of one structure."""
    return {k: (map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def build(pairs) -> dict:
    """The nested dict holding each (path, leaf) of ``pairs``."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out
