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

"""Party-local checkpoint / resume, and the full-job consistent cut (port
of ``rayfed_tpu/checkpoint.py``).

Each party snapshots its local state (model/optimizer trees of tensors,
plus the engine's seq-id counter) and, on restart, every party restores its
own snapshot and replays the driver program; the deterministic DAG
numbering then lines the parties back up without any cross-party
coordination.

Two layers (docs/ha.md):

- :func:`save_party_state` / :func:`restore_party_state` — a tree-only
  snapshot (tensors to disk, engine metadata alongside).
- :func:`save_job_state` / :func:`restore_job_state` — one CONSISTENT
  CUT of the whole control plane at a round boundary: model + optimizer
  state, every async aggregator session's exported state (buffer,
  staleness ledger, published model), every serving bank this party
  hosts, the membership epoch/sync-index/term, and the driver-side
  round-tag counters. The consistency contract: call it at a round
  boundary AFTER resolving the round's handles on every party — nothing
  is then in flight, so restoring the cut and replaying from round N+1
  continues aggregates bitwise (tests/test_torch_ha.py).

The on-disk format is this package's own, and needs only torch: one
``torch.save`` file per tree holding the tree's skeleton (dicts, lists,
tuples and Python scalars) and its tensors keyed by their tree paths,
read back with ``torch.load(weights_only=True)``. bf16 and f32 leaves
round-trip bitwise. The JAX package writes orbax; neither package reads
the other's checkpoint (ROADMAP Queue 3, a deliberate divergence). The
meta JSON is the JAX package's. An async session's pending masked groups
(secure aggregation) ride the cut with its buffer, and the privacy
plane's DP ledger rides it too, so the spent epsilon survives a restart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

from rayfed_tpu_torch._private.global_context import get_global_context

_META_FILE = "fed_meta.json"
_STATE_FILE = "state.pt"
_CONTROL_FILE = "fed_control.pt"
_FORMAT = "rayfed_tpu_torch.tree.v1"


@dataclasses.dataclass
class CheckpointConfig:
    """Job-checkpoint knobs (``config['checkpoint']``, validated at
    ``fed.init`` like every other section; docs/ha.md).

    Attributes:
        base_dir: default directory :func:`save_job_state` /
            :func:`restore_job_state` operate on when the caller passes
            none. Each cut lands in ``<base_dir>/step_<N>``. None =
            job-level checkpointing is explicit-path only.
        keep: how many newest step dirs to retain after each save (older
            complete cuts are pruned). 0 = keep everything.
    """

    base_dir: Optional[str] = None
    keep: int = 3

    def __post_init__(self) -> None:
        if int(self.keep) < 0:
            raise ValueError(
                f"checkpoint.keep must be >= 0, got {self.keep}"
            )

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "CheckpointConfig":
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - field_names)
        if unknown:
            raise ValueError(
                f"unknown checkpoint config key(s) {unknown}; known keys: "
                f"{sorted(field_names)}"
            )
        return cls(**data)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


from rayfed_tpu_torch.tenancy.context import JobScoped

_default_cfgs: "JobScoped[CheckpointConfig]" = JobScoped("checkpoint.default")


def set_default_checkpoint_config(data: Optional[Dict[str, Any]]) -> None:
    """Validate and install ``config['checkpoint']`` (called by
    ``fed.init``; raises on unknown keys so a typo rejects init)."""
    _default_cfgs.set(CheckpointConfig.from_dict(data))


def get_default_checkpoint_config() -> CheckpointConfig:
    return _default_cfgs.peek() or CheckpointConfig()


def reset_default_checkpoint_config() -> None:
    _default_cfgs.pop()


# ---------------------------------------------------------------------------
# The tree format: a skeleton of plain containers, tensors keyed by path
# ---------------------------------------------------------------------------


def _encode(node: Any, path: str, tensors: Dict[str, Any]) -> Any:
    """The skeleton of ``node``: ``[kind, ...]`` lists that
    ``torch.load(weights_only=True)`` accepts, each tensor moved into
    ``tensors`` under its tree path. An optimizer is stored as its
    ``state_dict()``."""
    import numpy as np
    import torch

    if isinstance(node, torch.Tensor):
        tensors[path] = node.detach().cpu()
        return ["tensor", path]
    if isinstance(node, np.ndarray):
        tensors[path] = torch.from_numpy(np.ascontiguousarray(node))
        return ["ndarray", path]
    if isinstance(node, torch.optim.Optimizer):
        return ["optimizer", _encode(node.state_dict(), path, tensors)]
    if isinstance(node, dict):
        keys = list(node)
        return ["dict", keys,
                [_encode(node[k], f"{path}/{k}", tensors) for k in keys]]
    if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        kind = "list" if isinstance(node, list) else "tuple"
        return [kind, [_encode(x, f"{path}/{i}", tensors)
                       for i, x in enumerate(node)]]
    if node is None or isinstance(node, (bool, int, float, str)):
        return ["value", node]
    if isinstance(node, np.generic):
        return ["value", node.item()]
    raise TypeError(
        f"checkpoint leaf {path or '/'!r} of type {type(node).__name__} "
        f"cannot be saved: leaves are tensors, numpy arrays, optimizers or "
        f"Python scalars in dicts, lists and tuples"
    )


def _decode(skel: Any, tensors: Dict[str, Any]) -> Any:
    kind = skel[0]
    if kind == "tensor":
        return tensors[skel[1]]
    if kind == "ndarray":
        return tensors[skel[1]].numpy()
    if kind == "optimizer":
        return _decode(skel[1], tensors)
    if kind == "dict":
        return {k: _decode(v, tensors) for k, v in zip(skel[1], skel[2])}
    if kind == "list":
        return [_decode(v, tensors) for v in skel[1]]
    if kind == "tuple":
        return tuple(_decode(v, tensors) for v in skel[1])
    return skel[1]


def _save_tree(file: str, tree: Any) -> None:
    import torch

    tensors: Dict[str, Any] = {}
    skel = _encode(tree, "", tensors)
    tmp = file + ".tmp"
    torch.save({"format": _FORMAT, "skeleton": skel, "tensors": tensors}, tmp)
    os.replace(tmp, file)  # a reader never sees a half-written file


def _load_tree(file: str) -> Any:
    import torch

    blob = torch.load(file, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != _FORMAT:
        raise ValueError(
            f"{file!r} is not a rayfed_tpu_torch checkpoint (an orbax "
            f"checkpoint of the JAX package cannot be read here)"
        )
    return _decode(blob["skeleton"], blob["tensors"])


def _place_like(got: Any, template: Any, path: str) -> Any:
    """``got`` on ``template``'s devices; raises on a mismatch in key,
    shape or dtype. An optimizer in the template loads the restored
    state dict and is returned."""
    import numpy as np
    import torch

    where = path or "/"
    if isinstance(template, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"checkpoint leaf {where!r}: the template holds "
                             f"a tensor, the checkpoint {type(got).__name__}")
        if tuple(got.shape) != tuple(template.shape) or got.dtype != template.dtype:
            raise ValueError(
                f"checkpoint leaf {where!r} is {tuple(got.shape)} "
                f"{got.dtype}, the template's {tuple(template.shape)} "
                f"{template.dtype}"
            )
        return got.to(template.device)
    if isinstance(template, torch.optim.Optimizer):
        template.load_state_dict(got)
        return template
    if isinstance(template, np.ndarray):
        got = np.asarray(got)
        if got.shape != template.shape or got.dtype != template.dtype:
            raise ValueError(
                f"checkpoint leaf {where!r} is {got.shape} {got.dtype}, the "
                f"template's {template.shape} {template.dtype}"
            )
        return got
    if isinstance(template, dict):
        if not isinstance(got, dict) or set(got) != set(template):
            have = sorted(map(str, got)) if isinstance(got, dict) else type(got).__name__
            raise ValueError(
                f"checkpoint keys at {where!r} are {have}, the template's "
                f"{sorted(map(str, template))}"
            )
        return {k: _place_like(got[k], template[k], f"{path}/{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(template):
            raise ValueError(f"checkpoint node {where!r} does not match the "
                             f"template's length {len(template)}")
        out = [_place_like(g, t, f"{path}/{i}")
               for i, (g, t) in enumerate(zip(got, template))]
        return type(template)(out) if isinstance(template, list) else tuple(out)
    return got


def save_party_state(path: str, state: Any, step: int = 0) -> None:
    """Snapshot ``state`` (a tree of tensors) plus engine metadata.

    ``path`` is a directory; one snapshot per path (use step-suffixed paths
    for retention).
    """
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    ctx = get_global_context()
    meta = {
        "step": step,
        "party": ctx.get_current_party() if ctx else None,
        "job": ctx.get_job_name() if ctx else None,
        # Snapshot of the deterministic DAG position: informational — on
        # restart the driver replays from the top and re-derives ids.
        # (peek, never next: advancing the counter here would desync this
        # party's rendezvous keys from its peers'.)
        "seq_id_watermark": ctx.peek_seq_id() if ctx else None,
    }
    _save_tree(os.path.join(path, _STATE_FILE), state)
    # The meta file marks the snapshot complete (latest_step reads it),
    # so it is written last.
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)


def restore_party_state(path: str, template: Optional[Any] = None) -> Any:
    """Restore a snapshot. With ``template`` (a tree like the saved one)
    each tensor goes to the template leaf's device and must match its
    key, shape and dtype (``ValueError`` otherwise), and an optimizer in
    the template loads the saved state dict; without it, tensors restore
    to the CPU and an optimizer as its state dict."""
    state = _load_tree(os.path.join(os.path.abspath(path), _STATE_FILE))
    if template is None:
        return state
    return _place_like(state, template, "")


def load_meta(path: str) -> dict:
    with open(os.path.join(os.path.abspath(path), _META_FILE)) as f:
        return json.load(f)


def latest_step(base_dir: str) -> Optional[int]:
    """Scan ``base_dir`` for step-suffixed snapshot dirs (``step_<N>``) and
    return the newest complete one."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for name in os.listdir(base_dir):
        if name.startswith("step_"):
            full = os.path.join(base_dir, name)
            if os.path.exists(os.path.join(full, _META_FILE)):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
    return max(steps) if steps else None


def step_dir(base_dir: str, step: int) -> str:
    return os.path.join(base_dir, f"step_{step}")


# ---------------------------------------------------------------------------
# Full-job consistent cut (docs/ha.md)
# ---------------------------------------------------------------------------


def _resolve_base_dir(base_dir: Optional[str]) -> str:
    base = base_dir or get_default_checkpoint_config().base_dir
    if not base:
        raise ValueError(
            "no checkpoint directory: pass base_dir= or set "
            'config["checkpoint"]["base_dir"] at fed.init'
        )
    return os.path.abspath(base)


def _prune_steps(base: str, keep: int) -> None:
    if keep <= 0:
        return
    steps = sorted(
        int(name[5:])
        for name in os.listdir(base)
        if name.startswith("step_") and name[5:].isdigit()
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(base, f"step_{s}"), ignore_errors=True)


def _on_party_device(tree: Any) -> Any:
    """``tree``'s tensors on the party's card when the job placed on one
    (``transport="cuda"`` or ``party_mesh``), where the offers an
    adopted aggregator folds will arrive; else as they are (the CPU)."""
    import torch

    from rayfed_tpu_torch import mesh, tree_util

    dev = mesh.get_party_device()
    if dev is None:
        return tree
    return tree_util.tree_map(
        lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


def _export_banks() -> Dict[str, Any]:
    """The exported state of every serving bank this party hosts."""
    import sys

    server_mod = sys.modules.get("rayfed_tpu_torch.serving.server")
    if server_mod is None:
        return {}
    servers = dict(server_mod._servers.get())
    return {name: servers[name].bank.export_state() for name in sorted(servers)}


def _restore_banks(banks: Dict[str, Any]) -> None:
    """Continue each checkpointed bank's versions in the server of the
    same name, where this party hosts one."""
    import sys

    server_mod = sys.modules.get("rayfed_tpu_torch.serving.server")
    if server_mod is None:
        return
    servers = server_mod._servers.get()
    for name, state in banks.items():
        if name in servers:
            servers[name].bank.restore_state(state)


def save_job_state(
    base_dir: Optional[str] = None,
    *,
    step: int,
    model: Any = None,
    opt_state: Any = None,
    extra: Any = None,
) -> str:
    """One consistent cut of this party's whole job state at round
    boundary ``step``, under ``<base_dir>/step_<step>``.

    The cut bundles: ``model`` + ``opt_state`` (a tree or a
    ``torch.optim`` optimizer, stored as its state dict) + ``extra``;
    every async aggregator session this party hosts (exported buffer,
    staleness ledger, published model); every serving bank it hosts; the
    driver-side round-tag counters; and the membership view / sync index
    / term (when a manager is installed). CONSISTENCY CONTRACT: call at a
    round boundary after resolving the round's handles on EVERY party —
    with nothing in flight, each party's local cut composes into one
    global cut, and a restart resumes bitwise (tests/test_torch_ha.py).

    Returns the step directory written."""
    import rayfed_tpu_torch.async_rounds as async_rounds
    from rayfed_tpu_torch.membership.manager import get_membership_manager
    from rayfed_tpu_torch.privacy.manager import get_privacy_manager

    base = _resolve_base_dir(base_dir)
    path = step_dir(base, int(step))
    os.makedirs(path, exist_ok=True)

    arrays = {}
    if model is not None:
        arrays["model"] = model
    if opt_state is not None:
        arrays["opt_state"] = opt_state
    if extra is not None:
        arrays["extra"] = extra
    if arrays:
        _save_tree(os.path.join(path, _STATE_FILE), arrays)

    with async_rounds._sessions_lock:
        session_map = dict(async_rounds._sessions.get())
    sessions = {
        name: agg.export_state() for name, agg in session_map.items()
    }
    with async_rounds._tags_lock:
        round_tags = dict(async_rounds._driver_round_tags.get())
    membership = get_membership_manager()
    privacy = get_privacy_manager()
    control = {
        "async_sessions": sessions,
        "round_tags": round_tags,
        "membership": (
            membership.export_snapshot() if membership is not None else None
        ),
        "model_banks": _export_banks(),
        "privacy_ledger": (
            privacy.ledger_snapshot() if privacy is not None else None
        ),
    }
    _save_tree(os.path.join(path, _CONTROL_FILE), control)

    ctx = get_global_context()
    meta = {
        "step": int(step),
        "party": ctx.get_current_party() if ctx else None,
        "job": ctx.get_job_name() if ctx else None,
        "seq_id_watermark": ctx.peek_seq_id() if ctx else None,
        "kind": "job",
        "has_arrays": sorted(arrays),
        "sessions": sorted(sessions),
        "membership_epoch": (
            membership.current_epoch() if membership is not None else None
        ),
        "membership_term": (
            membership.term() if membership is not None else None
        ),
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)
    _prune_steps(base, int(get_default_checkpoint_config().keep))
    return path


def restore_job_state(
    base_dir: Optional[str] = None,
    *,
    step: Optional[int] = None,
    template: Any = None,
    install: bool = True,
) -> Dict[str, Any]:
    """Reload a :func:`save_job_state` cut (the newest step when
    ``step`` is None) and — with ``install=True`` — fast-forward the
    running engine to it: every checkpointed aggregator session (its
    tensors on the party's card when the job bound one) is adopted into
    this party's registry with its buffer and pending masked groups, the
    driver round-tag counters resume where they left off, and the
    membership manager (when installed) fast-forwards to the cut's
    epoch/sync index/term, and the privacy manager (when installed)
    reloads the cut's DP ledger.

    ``template`` (see :func:`restore_party_state`) places the tensors on
    its devices and must mirror the saved ``{"model": ..., "opt_state":
    ...}`` shape; an optimizer there loads the saved optimizer state.
    Returns ``{"step", "path", "model", "opt_state", "extra", "meta"}``
    (array entries None when the cut carried none)."""
    import rayfed_tpu_torch.async_rounds as async_rounds
    from rayfed_tpu_torch.membership.manager import get_membership_manager
    from rayfed_tpu_torch.privacy.manager import get_privacy_manager

    base = _resolve_base_dir(base_dir)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(
                f"no complete job checkpoint under {base!r}"
            )
    path = step_dir(base, int(step))
    meta = load_meta(path)

    arrays: Dict[str, Any] = {}
    if meta.get("has_arrays"):
        arrays = restore_party_state(path, template)

    control: Dict[str, Any] = {}
    control_path = os.path.join(path, _CONTROL_FILE)
    if os.path.exists(control_path):
        control = _load_tree(control_path)
    if control.get("async_sessions"):
        control["async_sessions"] = _on_party_device(control["async_sessions"])

    if install and control:
        for name, state in (control.get("async_sessions") or {}).items():
            agg = async_rounds._get_or_create_session(
                name, state["cfg"], None
            )
            agg.adopt_state(state)
        with async_rounds._tags_lock:
            async_rounds._driver_round_tags.get().update(
                control.get("round_tags") or {}
            )
        membership = get_membership_manager()
        if membership is not None and control.get("membership"):
            membership.restore_snapshot(control["membership"])
        privacy = get_privacy_manager()
        if privacy is not None and control.get("privacy_ledger"):
            privacy.ledger_restore(control["privacy_ledger"])
        _restore_banks(control.get("model_banks") or {})

    return {
        "step": int(step),
        "path": path,
        "model": arrays.get("model"),
        "opt_state": arrays.get("opt_state"),
        "extra": arrays.get("extra"),
        "meta": meta,
        "control": control,
    }
