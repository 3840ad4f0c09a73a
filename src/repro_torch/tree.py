"""Trees of tensors: the nested dicts, lists and NamedTuples that the
port's parameters, optimizer state and train state are made of.

Leaves are visited in ``jax.tree_util``'s order — a NamedTuple by its
fields, a dict by its sorted keys, a list or tuple by index; ``None`` is
an empty subtree; any other tuple subclass (a ``PartitionSpec``, a
``torch.Size``) is a leaf — and each comes with its path, whose elements are a
field as ``".name"``, a dict key as itself and an index as an int.  So
``key(path)`` is the reference checkpoint's key of the same leaf
(``repro.checkpoint._flatten``): ``.params/layers/slot0/ffn/w1``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf of ``tree``, in the reference's order."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for f in tree._fields:
            yield from leaves_with_path(getattr(tree, f), path + ("." + f,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif type(tree) in (list, tuple):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def key(path: Path) -> str:
    """The reference checkpoint's key of a leaf: the path joined by
    ``/``."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree, *rest, path: Path = (),
             with_path: bool = False):
    """``fn(leaf, *leaves of rest)`` over the structure of ``tree`` (the
    other trees share it); ``with_path=True`` passes the path first."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                     path=path + ("." + f,), with_path=with_path)
            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,),
                            with_path=with_path)
                for k, v in tree.items()}
    if type(tree) in (list, tuple):
        out = [tree_map(fn, v, *(r[i] for r in rest), path=path + (i,),
                        with_path=with_path)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)


def unflatten_like(tree_like, flat: dict, path: Path = ()):
    """A tree of ``tree_like``'s structure whose leaves are
    ``flat[key(path)]``; a missing key raises ``KeyError``, as the
    reference's ``_unflatten_into``."""
    def take(p, _):
        k = key(p)
        if k not in flat:
            raise KeyError(f"checkpoint missing leaf '{k}'")
        return flat[k]
    return tree_map(take, tree_like, path=path, with_path=True)


def pick(tree, i: int):
    """The ``i``-th member of every tuple leaf of a tree of dicts, lists
    and NamedTuples — one of the trees that a ``tree_map`` returning
    tuples zips together."""
    if _is_namedtuple(tree):
        return type(tree)(*(pick(getattr(tree, f), i) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [pick(v, i) for v in tree]
    return tree[i]
