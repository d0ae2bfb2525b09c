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

"""Parameter partition rules and mesh helpers (port of
``rayfed_tpu/parallel/sharding.py``) on a torch ``DeviceMesh``.

Megatron-style tensor parallelism as rules: QKV projections and the MLP's
up/gate shard their output features over the ``model`` mesh dim,
output/down projections their input features, so each block needs one
all-reduce per residual add (DTensor inserts it: the row-parallel product
is ``Partial`` until the residual add makes it ``Replicate``). Batch dims
shard over ``party`` x ``data``, so the gradient reduction over those dims
is the federated aggregate.

A spec is a tuple with one entry per tensor dim: None, a mesh dim name, or
a tuple of names (the JAX package's ``PartitionSpec`` entries, so the two
compare as tuples). :func:`placements_for` turns a spec into DTensor
placements: ``Shard(d)`` on each mesh dim that names tensor dim ``d``,
``Replicate()`` elsewhere; a tensor dim over several mesh dims shards on
each of them, in the mesh's order (the first mesh dim outermost).

Expert parallelism places nothing here: the expert rows replicate, and an
``expert`` mesh dim of size > 1 raises (ROADMAP Queue 1 item 13b, with
sequence parallelism, whose sharded sequence the attention refuses).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# (regex over param path, spec): the first match wins. Paths look like
# "layers/wq", "embed", "layers/w_down". Stacked layer leaves carry a
# leading n_layers dim, handled by spec_for below.
TRANSFORMER_RULES: List[Tuple[str, Spec]] = [
    (r"layers/w[qkv]$", (None, "model", None)),
    (r"layers/wo$", ("model", None, None)),
    (r"layers/w_(gate|up)$", (None, "model")),
    (r"layers/w_down$", ("model", None)),
    (r"layers/ln[12]$", ()),
    # MoE FFN: experts shard over the "expert" axis; router replicated.
    (r"layers/moe/router$", ()),
    (r"layers/moe/w_(up|down)$", ("expert", None, None)),
    (r"embed$", (None, None)),
    (r"lm_head$", (None, "model")),
    (r"ln_f$", ()),
]

_EXPERT_LATER = (
    "expert parallelism (an 'expert' mesh dim of size > 1) is ROADMAP "
    "Queue 1 item 13b"
)


def spec_for(path_str: str, leaf, rules, stacked_prefix: str = "layers") -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path_str):
            if (
                stacked_prefix
                and path_str.startswith(stacked_prefix)
                and len(spec) == leaf.ndim - 1
            ):
                # Stacked layer leaf: leading n_layers dim is unsharded.
                return (None,) + tuple(spec)
            return tuple(spec)
    return ()


def _map_with_path(fn, tree, prefix: str = "", is_leaf=None):
    """``fn(path, leaf)`` over a dict/list/tuple tree, paths joined by "/"
    as the JAX package's ``_path_str`` joins key paths."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix[:-1], tree)
    if isinstance(tree, dict):
        return type(tree)(
            (k, _map_with_path(fn, v, f"{prefix}{k}/", is_leaf))
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_with_path(fn, v, f"{prefix}{i}/", is_leaf)
            for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _entry(names):
    """A spec entry over ``names``: None, the one name, or the tuple (as
    ``PartitionSpec`` writes a one-name tuple)."""
    names = tuple(names)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def make_param_specs(params, rules=TRANSFORMER_RULES):
    """Tree of specs matching ``params`` by path regex."""
    return _map_with_path(lambda path, leaf: spec_for(path, leaf, rules),
                          params)


def _mesh_dims(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def prune_spec_to_mesh(spec: Spec, mesh) -> Spec:
    """Drop axis names the mesh does not have (e.g. the 'model' rules on a
    party x expert mesh): absent axes mean 'replicated here'.

    As in the JAX package, on a mesh with no ``expert`` dim but a
    ``model`` dim the expert dimension names ``model`` instead; the
    placements (:func:`make_param_shardings`) do not shard experts until
    item 13b."""
    names = _mesh_dims(mesh)

    def one(name):
        if name in names:
            return name
        if name == "expert" and "model" in names:
            return "model"
        return None

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = []
            for a in entry:
                m = one(a)
                if m is not None and m not in kept:
                    kept.append(m)
            return _entry(kept)
        return one(entry)

    return tuple(keep(e) for e in spec)


def check_mesh(mesh) -> None:
    """Raise for a mesh dim this port cannot place yet: ``expert`` of size
    > 1 (item 13b)."""
    names = _mesh_dims(mesh)
    if "expert" in names and mesh.size(names.index("expert")) > 1:
        raise NotImplementedError(_EXPERT_LATER)


def placements_for(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that names tensor dim ``d``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    check_mesh(mesh)
    names = _mesh_dims(mesh)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in entry if isinstance(entry, (tuple, list)) else (entry,):
            if name in names:
                placements[names.index(name)] = Shard(d)
    return placements


def _without_experts(spec: Spec) -> Spec:
    def drop(entry):
        if isinstance(entry, (tuple, list)):
            return _entry(a for a in entry if a != "expert")
        return None if entry == "expert" else entry

    return tuple(drop(e) for e in spec)


def _leaf_placements(path: str, leaf, mesh, rules) -> list:
    spec = _without_experts(spec_for(path, leaf, rules))
    return placements_for(prune_spec_to_mesh(spec, mesh), mesh)


def make_param_shardings(mesh, params, rules=TRANSFORMER_RULES):
    """Tree of DTensor placement lists for ``params`` on ``mesh``, by the
    rules."""
    return _map_with_path(
        lambda path, leaf: _leaf_placements(path, leaf, mesh, rules), params)


def shard_params(mesh, params, rules=TRANSFORMER_RULES):
    """Place a tree of full tensors (the same values on every rank) onto
    the mesh by the rules (``distribute_tensor``): a tree of DTensors. A
    leaf that is a DTensor already is redistributed to its rule's
    placements."""
    return place_tree(mesh, params, placements_by_path(mesh, params, rules))


def leaf_paths(tree, is_leaf=None) -> list:
    """[(path, leaf)] of a dict/list/tuple tree, in order."""
    out = []
    _map_with_path(lambda path, leaf: out.append((path, leaf)), tree,
                   is_leaf=is_leaf)
    return out


def placements_by_path(mesh, params, rules=TRANSFORMER_RULES) -> dict:
    """{path: placements} of each leaf of ``params`` by the rules."""
    return {path: _leaf_placements(path, leaf, mesh, rules)
            for path, leaf in leaf_paths(params)}


def place_tree(mesh, tree, placements: dict):
    """Each leaf of ``tree`` placed by ``placements[path]``: a full tensor
    by ``distribute_tensor``, a DTensor by ``redistribute`` (nothing moves
    when it is placed so already)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(path, x):
        pl = placements[path]
        if isinstance(x, DTensor):
            if list(x.placements) == list(pl):
                return x
            return x.redistribute(mesh, pl)
        return distribute_tensor(x.detach(), mesh, pl)

    return _map_with_path(one, tree)


def batch_spec(mesh, party_axis: Optional[str] = "party",
               data_axis: Optional[str] = "data",
               seq_axis: Optional[str] = None) -> Spec:
    """Spec of a (B, S) token batch: batch over party x data, optionally
    the sequence over seq."""
    names = _mesh_dims(mesh)
    first = _entry(a for a in (party_axis, data_axis) if a and a in names)
    if seq_axis and seq_axis in names:
        return (first, seq_axis)
    return (first,)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card for a CUDA mesh
    (with no card it raises), else the CPU."""
    if mesh.device_type == "cuda":
        from rayfed_tpu_torch.utils import resolve_device

        resolve_device("cuda")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_size(mesh, name: Optional[str]) -> int:
    """The size of mesh dim ``name``; 1 when the mesh has no such dim."""
    names = _mesh_dims(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def place(x: torch.Tensor, mesh, placements: Sequence) -> "torch.Tensor":
    """A DTensor of the full tensor ``x`` (the same on every rank) with
    ``placements``, taking this rank's chunk with no communication. Each
    sharded dim must divide evenly."""
    from torch.distributed.tensor import DTensor, Shard

    coord = mesh.get_coordinate()
    local = x
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} of a {tuple(x.shape)} tensor does not "
                    f"divide over mesh dim {_mesh_dims(mesh)[i]!r} of size "
                    f"{n}")
            local = local.chunk(n, dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, list(placements),
                              run_check=False)


def full(x):
    """``x`` as a plain tensor: a DTensor's full value on every rank,
    anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def gather_params(params):
    """A tree of DTensors as full plain tensors (every rank gets all)."""
    return _map_with_path(lambda path, x: full(x), params)
