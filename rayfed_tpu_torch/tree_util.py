# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Minimal pytree flatten/unflatten for the core engine.

Capability parity with the reference's vendored pytree
(``fed/tree_util.py:180-231``): the dispatch layer must find ``FedObject``
leaves nested inside dict/list/tuple/namedtuple/OrderedDict argument
structures. We keep this dependency-free on purpose — the core engine must
import without JAX so that control-plane-only party processes stay light
(SURVEY.md C7).

In ``rayfed_tpu_torch`` this module is a copy of ``rayfed_tpu/tree_util.py``
and also carries parameter trees of tensors: dicts keep their insertion
order, so the JAX package's key paths survive unchanged.

This is an original implementation: a single recursive flatten that records
a spec tree, rather than the reference's registry of per-type
flatten/unflatten pairs.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "leaves_like",
           "TreeSpec"]

_LEAF = "leaf"


class TreeSpec:
    """Structure descriptor produced by :func:`tree_flatten`.

    ``kind`` is one of ``leaf``, ``list``, ``tuple``, ``namedtuple``,
    ``dict``, ``odict``; ``meta`` holds keys (dicts) or the namedtuple type;
    ``children`` the child specs in flatten order.
    """

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any = None, children: Tuple["TreeSpec", ...] = ()):
        self.kind = kind
        self.meta = meta
        self.children = children

    @property
    def num_leaves(self) -> int:
        if self.kind == _LEAF:
            return 1
        return sum(c.num_leaves for c in self.children)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TreeSpec)
            and self.kind == other.kind
            and self.meta == other.meta
            and self.children == other.children
        )

    def __repr__(self) -> str:
        if self.kind == _LEAF:
            return "*"
        return f"{self.kind}{list(self.children)!r}"


def _is_namedtuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields") and hasattr(obj, "_make")


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeSpec]:
    """Flatten ``tree`` into (leaves, spec). Containers recognized: list,
    tuple, namedtuple, dict, OrderedDict. Everything else is a leaf."""
    leaves: List[Any] = []

    def go(node: Any) -> TreeSpec:
        if _is_namedtuple(node):
            return TreeSpec("namedtuple", type(node), tuple(go(c) for c in node))
        if isinstance(node, OrderedDict):
            return TreeSpec("odict", list(node.keys()), tuple(go(node[k]) for k in node))
        if isinstance(node, dict):
            keys = list(node.keys())
            return TreeSpec("dict", keys, tuple(go(node[k]) for k in keys))
        if isinstance(node, list):
            return TreeSpec("list", None, tuple(go(c) for c in node))
        if isinstance(node, tuple):
            return TreeSpec("tuple", None, tuple(go(c) for c in node))
        leaves.append(node)
        return TreeSpec(_LEAF)

    spec = go(tree)
    return leaves, spec


def tree_unflatten(leaves: List[Any], spec: TreeSpec) -> Any:
    """Inverse of :func:`tree_flatten`. Consumes ``leaves`` in order."""
    it = iter(leaves)

    def go(s: TreeSpec) -> Any:
        if s.kind == _LEAF:
            return next(it)
        children = [go(c) for c in s.children]
        if s.kind == "list":
            return children
        if s.kind == "tuple":
            return tuple(children)
        if s.kind == "namedtuple":
            return s.meta(*children)
        if s.kind == "dict":
            return dict(zip(s.meta, children))
        if s.kind == "odict":
            return OrderedDict(zip(s.meta, children))
        raise ValueError(f"unknown tree spec kind: {s.kind}")

    out = go(spec)
    # Detect leaf-count mismatch (same contract as jax.tree_util).
    try:
        next(it)
    except StopIteration:
        return out
    raise ValueError("too many leaves for tree spec")


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([fn(x) for x in leaves], spec)


def leaves_like(tree: Any, spec: TreeSpec) -> List[Any]:
    """``tree``'s leaves in the order of ``spec``, dicts matched by key:
    a tree from the JAX package has its dict keys sorted (as
    ``jax.tree_util`` rebuilds dicts), a tree of this package keeps its
    insertion order, and two such trees pair their leaves by key path."""
    out = []

    def go(node, s):
        if s.kind == "leaf":
            if isinstance(node, (dict, list, tuple)):
                raise ValueError(f"tree structures differ at {node!r}")
            out.append(node)
        elif s.kind in ("dict", "odict"):
            if not isinstance(node, dict) or set(node) != set(s.meta):
                raise ValueError(f"tree structures differ: keys {s.meta}")
            for k, c in zip(s.meta, s.children):
                go(node[k], c)
        else:
            if (not isinstance(node, (list, tuple))
                    or len(node) != len(s.children)):
                raise ValueError(f"tree structures differ: {spec}")
            for n, c in zip(node, s.children):
                go(n, c)

    go(tree, spec)
    return out
