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

"""Federated train steps on one device or over a DeviceMesh (port of
``rayfed_tpu/parallel/train.py``).

``make_fed_train_step`` builds ``(init_fn, step_fn)`` with the reference's
meaning: ``init_fn`` makes params and optimizer state, ``step_fn`` takes one
AdamW step over a pre-shifted (B, S) batch. On one device that is a
party's local step, and federated averaging happens between rounds over
whole parameter trees (``ops/aggregate.tree_mean``). Over a
``torch.distributed`` DeviceMesh whose dims carry the JAX mesh's axis names
(``mesh.build_mesh``), one step covers the mesh:

 - ``party`` x ``data`` shard the batch. The loss is a mean over the
   global batch, so each parameter's gradient comes out partial over those
   dims, and making it replicated (an all-reduce) IS the federated
   aggregate (synchronized FedSGD).
 - ``model`` shards attention heads, the MLP hidden and the vocab by the
   rules of :mod:`rayfed_tpu_torch.parallel.sharding` (tensor
   parallelism): params are DTensors, the flash kernels run on each
   rank's heads and batch rows, the head + CE is vocab-parallel.
 - ``seq`` (sequence parallelism: ring or Ulysses attention) is ROADMAP
   Queue 1 item 13b, and a seq dim of size > 1 raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.utils import DeviceLike, is_cuda_backend, resolve_device

_SEQ_LATER = (
    "sequence parallelism (ring / Ulysses attention) is ROADMAP Queue 1 "
    "item 13b"
)


def make_optimizer(params, lr: float = 3e-4, weight_decay: float = 0.01):
    """AdamW over every leaf of ``params`` with the reference's
    hyperparameters (``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=...)``: the same decoupled decay, on every leaf)."""
    leaves, _ = tree_util.tree_flatten(params)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def _copy_adamw(opt: torch.optim.Optimizer, leaves):
    """A new AdamW over ``leaves`` with ``opt``'s settings and a clone of
    its state."""
    group = opt.param_groups[0]
    new_opt = torch.optim.AdamW(
        leaves, lr=group["lr"], betas=group["betas"], eps=group["eps"],
        weight_decay=group["weight_decay"],
    )
    state = opt.state_dict()
    state["state"] = {
        i: {k: v.clone() for k, v in s.items()}
        for i, s in state["state"].items()
    }
    new_opt.load_state_dict(state)
    return new_opt


def _copy_state(params, opt):
    """Fresh leaves and a fresh optimizer with cloned moments, for a step
    that must leave its inputs untouched (``donate=False``)."""
    new = tree_util.tree_map(
        lambda p: p.detach().clone().requires_grad_(True), params
    )
    leaves = tree_util.tree_flatten(new)[0]
    if isinstance(opt, Zero1AdamW):
        return new, opt.copy_for(leaves)
    return new, _copy_adamw(opt, leaves)


class Zero1AdamW:
    """AdamW whose moments are sharded ZeRO-1 style (the reference's
    ``shard_opt_state=True``): each moment keeps its parameter's
    placements and also shards its first unsharded dim that divides by the
    data-parallel size over the data-parallel mesh dims, so each of those
    ranks keeps 1/dp of the moments.

    ``torch.optim.AdamW`` keeps a moment in its parameter's placements,
    so the update runs on slices: each step takes this rank's slice of
    each (reduced) gradient and parameter in the moments' placements,
    runs ``make_optimizer``'s AdamW on the slices, and redistributes the
    new slices to the parameters' placements (an all-gather over the
    data-parallel dims). ``moments()`` lists the moment DTensors."""

    def __init__(self, leaves, dp_dims, lr: float, weight_decay: float = 0.01,
                 _opt=None):
        self.leaves = list(leaves)
        self.dp_dims = tuple(dp_dims)
        self.placements = [self._layout(p) for p in self.leaves]
        # A moment laid out as its param takes the param itself as its
        # slice (no copy).
        self.slices = [
            p.detach() if list(pl) == list(p.placements)
            else p.detach().redistribute(p.device_mesh, pl).clone()
            for p, pl in zip(self.leaves, self.placements)]
        self.opt = (make_optimizer(self.slices, lr, weight_decay)
                    if _opt is None else _copy_adamw(_opt, self.slices))

    def _layout(self, p) -> list:
        from torch.distributed.tensor import Replicate, Shard

        mesh = p.device_mesh
        placements = list(p.placements)
        dp = 1
        for i in self.dp_dims:
            dp *= mesh.size(i)
        if dp == 1:
            return placements
        sharded = {pl.dim for pl in placements if isinstance(pl, Shard)}
        for d in range(p.ndim):
            if d not in sharded and p.shape[d] and p.shape[d] % dp == 0:
                for i in self.dp_dims:
                    if isinstance(placements[i], Replicate):
                        placements[i] = Shard(d)
                break
        return placements

    @property
    def param_groups(self):
        return self.opt.param_groups

    def moments(self) -> list:
        return [s[k] for s in self.opt.state.values()
                for k in ("exp_avg", "exp_avg_sq") if k in s]

    def step(self) -> None:
        with torch.no_grad():
            for p, s, pl in zip(self.leaves, self.slices, self.placements):
                mesh = p.device_mesh
                s.copy_(p.detach().redistribute(mesh, pl))
                s.grad = p.grad.redistribute(mesh, pl)
            self.opt.step()
            for p, s in zip(self.leaves, self.slices):
                p.copy_(s.redistribute(p.device_mesh, p.placements))

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)
        for p in self.leaves:
            p.grad = None

    def copy_for(self, leaves) -> "Zero1AdamW":
        """A copy over ``leaves`` (same shapes and placements) with a
        clone of this optimizer's state."""
        return Zero1AdamW(leaves, self.dp_dims, 0.0, _opt=self.opt)


def make_fed_train_step(
    cfg: tfm.TransformerConfig,
    mesh=None,
    *,
    device: DeviceLike = None,
    party_axis: Optional[str] = "party",
    data_axis: Optional[str] = "data",
    seq_axis: Optional[str] = None,
    lr: float = 3e-4,
    remat: tfm.Remat = False,
    attn: str = "auto",
    seq_parallel: str = "ring",
    accum_steps: int = 1,
    shard_opt_state: bool = False,
    donate: bool = True,
    loss_chunk: Optional[int] = 512,
):
    """Build ``(init_fn, step_fn)`` over ``mesh``: a DeviceMesh
    (``mesh.build_mesh``), or a device for the one-device step (CUDA
    unless ``"cpu"``; ``device=`` says the same).

    ``init_fn(rng, sample_tokens=None) -> (params, opt_state)``: ``rng`` is
    an int seed or a ``torch.Generator`` for fresh params, or a tree of
    numpy arrays (for example the JAX package's params) carried over by
    ``params_from_numpy``; over a mesh the params are DTensors placed by
    the partition rules. ``opt_state`` is the ``torch.optim.AdamW`` over
    the params' leaves (:class:`Zero1AdamW` under ``shard_opt_state``).
    ``step_fn(params, opt_state, inputs, targets) -> (params, opt_state,
    loss)`` takes one step over pre-shifted (B, S) input/target blocks,
    the whole global batch on every rank (each keeps its rows of the
    ``party`` x ``data`` split); ``loss`` is the global batch's mean, a
    0-dim f32 tensor on the device (plain, on every rank).

    ``attn`` selects the attention: ``"flash"`` = the flash kernels
    (O(S) memory, differentiable; the plain versions on the CPU),
    ``"xla"`` = the dense reference attention, ``"auto"`` = flash on CUDA,
    dense elsewhere. ``remat=True`` checkpoints each layer;
    ``remat="attn"`` checkpoints each layer but keeps its attention output,
    so the backward does not run the flash forward again
    (``models.transformer.hidden_states``).
    ``accum_steps > 1`` splits the batch into that many strided
    microbatches (rows ``i::accum_steps``, as the reference; over a mesh,
    each rank's own rows, which is the same row set when its rows divide
    by ``accum_steps``) and averages their gradients. ``loss_chunk``
    positions per checkpointed head+CE chunk (None for one pass).

    ``shard_opt_state=True`` shards the AdamW moments ZeRO-1 style over
    the mesh's ``party`` x ``data`` dims (:class:`Zero1AdamW`); on one
    device, or a mesh whose data-parallel dims are 1, the moments keep
    their parameters' layout, as the reference's do. ``seq_axis`` naming a
    mesh dim of size > 1, or given for the one-device step, raises (item
    13b); ``seq_parallel`` is validated as the reference does.

    ``donate=True`` (default) is an in-place update: the step writes the
    new values into the params' and optimizer's own tensors and returns
    the same objects, so a caller that handed those tensors to another
    consumer must copy them first (the reference's donation contract).
    ``donate=False`` leaves the inputs untouched and returns new ones.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if attn not in ("auto", "flash", "xla"):
        raise ValueError(f"attn must be 'auto', 'flash', or 'xla'; got {attn!r}")
    if seq_parallel not in ("ring", "a2a"):
        raise ValueError(
            f"seq_parallel must be 'ring' or 'a2a'; got {seq_parallel!r}"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    tfm.check_remat(remat)
    if isinstance(mesh, DeviceMesh):
        if device is not None:
            raise TypeError("pass a mesh or a device, not both")
        return _make_mesh_step(
            cfg, mesh, party_axis=party_axis, data_axis=data_axis,
            seq_axis=seq_axis, lr=lr, remat=remat, attn=attn,
            accum_steps=accum_steps, shard_opt_state=shard_opt_state,
            donate=donate, loss_chunk=loss_chunk)
    if mesh is not None:
        if device is not None:
            raise TypeError("pass a mesh or a device, not both")
        device = mesh
    if seq_axis is not None:
        raise NotImplementedError(
            f"seq_axis on one device: {_SEQ_LATER}; the one-device step "
            "has no sequence to shard")
    dev = resolve_device(device)
    if attn == "auto":
        attn = "flash" if is_cuda_backend(dev) else "xla"
    attn_fn = _attn_fn(attn)

    def loss_fn(params, inputs, targets):
        return tfm.lm_loss_pair(params, inputs, targets, cfg, attn_fn,
                                remat=remat, loss_chunk=loss_chunk)

    def grad_step(params, inputs, targets):
        """Loss, with the gradient left in each leaf's ``.grad``."""
        _check_accum(inputs.shape[0], accum_steps)
        return _accumulate(
            params, [(params, inputs[i::accum_steps], targets[i::accum_steps])
                     for i in range(accum_steps)], loss_fn, dev)

    def init_fn(rng, sample_tokens=None):
        params = _init_params(rng, cfg, dev)
        params = tree_util.tree_map(lambda p: p.requires_grad_(True), params)
        return params, make_optimizer(params, lr)

    def as_tokens(x):
        return torch.as_tensor(x, device=dev).long()

    def step_fn(params, opt_state, inputs, targets):
        if not donate:
            params, opt_state = _copy_state(params, opt_state)
        loss = grad_step(params, as_tokens(inputs), as_tokens(targets))
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return init_fn, step_fn


def _attn_fn(attn: str):
    if attn == "flash":
        from rayfed_tpu_torch.ops.flash_attention import make_flash_attn_fn

        return make_flash_attn_fn()
    return None


def _init_params(rng, cfg, dev):
    if isinstance(rng, dict):
        return tfm.params_from_numpy(rng, dev)
    return tfm.init_params(rng, cfg, dev)


def _check_accum(rows: int, accum_steps: int, what: str = "batch") -> None:
    if rows % accum_steps:
        raise ValueError(
            f"{what} {rows} not divisible by accum_steps={accum_steps}"
        )


def _accumulate(params, microbatches, loss_fn, dev):
    """The mean loss of ``microbatches`` (``loss_fn`` arguments), each
    backpropagated, with the mean gradient left in each leaf's ``.grad``
    (one microbatch: its loss and gradient as they are)."""
    if len(microbatches) == 1:
        loss = loss_fn(*microbatches[0])
        loss.backward()
        return loss.detach()
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for args in microbatches:
        loss = loss_fn(*args)
        loss.backward()
        total = total + loss.detach()
    inv = 1.0 / len(microbatches)
    for p in tree_util.tree_flatten(params)[0]:
        p.grad.mul_(inv)
    return total * inv


def _make_mesh_step(cfg, mesh, *, party_axis, data_axis, seq_axis, lr, remat,
                    attn, accum_steps, shard_opt_state, donate, loss_chunk):
    """``make_fed_train_step`` over a DeviceMesh."""
    from torch.distributed.tensor import DTensor

    from rayfed_tpu_torch.parallel import sharding as shd

    shd.check_mesh(mesh)
    if seq_axis is not None and shd.mesh_size(mesh, seq_axis) > 1:
        raise NotImplementedError(
            f"seq_axis={seq_axis!r} (size {shd.mesh_size(mesh, seq_axis)}): "
            f"{_SEQ_LATER}")
    tfm.register_dtensor_rules()
    dev = shd.mesh_device(mesh)
    if attn == "auto":
        attn = "flash" if dev.type == "cuda" else "xla"
    attn_fn = _attn_fn(attn)
    names = tuple(mesh.mesh_dim_names)
    batch_placements = shd.placements_for(
        shd.batch_spec(mesh, party_axis, data_axis), mesh)
    dp_dims = tuple(names.index(a) for a in (party_axis, data_axis)
                    if a and a in names)

    def place_batch(x):
        x = torch.as_tensor(x, device=dev).long()
        return shd.place(x, mesh, batch_placements)

    def loss_fn(params, inputs, targets):
        loss = tfm.lm_loss_pair(params, inputs, targets, cfg, attn_fn,
                                remat=remat, loss_chunk=loss_chunk)
        # The global mean, on every rank; its backward keeps each rank's
        # gradient partial over the data dims.
        return loss.full_tensor()

    def grad_step(params, inputs, targets):
        _check_accum(len(inputs), accum_steps)
        x = place_batch(inputs).to_local()
        t = place_batch(targets).to_local()
        _check_accum(x.shape[0], accum_steps, "each rank's batch rows,")
        # Each rank's rows i::accum_steps: a strided microbatch of every
        # shard, no token crosses a rank.
        return _accumulate(params, [
            (params, *(DTensor.from_local(a[i::accum_steps], mesh,
                                          batch_placements, run_check=False)
                       for a in (x, t)))
            for i in range(accum_steps)], loss_fn, dev)

    def reduce_grads(params):
        # Partial over the data dims -> replicated: the federated
        # aggregate of the gradient.
        for p in tree_util.tree_flatten(params)[0]:
            p.grad = p.grad.redistribute(mesh, p.placements)

    def init_fn(rng, sample_tokens=None):
        params = shd.shard_params(mesh, _init_params(rng, cfg, dev))
        params = tree_util.tree_map(lambda p: p.requires_grad_(True), params)
        leaves = tree_util.tree_flatten(params)[0]
        if shard_opt_state:
            return params, Zero1AdamW(leaves, dp_dims, lr)
        return params, make_optimizer(params, lr)

    def step_fn(params, opt_state, inputs, targets):
        if not donate:
            params, opt_state = _copy_state(params, opt_state)
        loss = grad_step(params, inputs, targets)
        reduce_grads(params)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return init_fn, step_fn
