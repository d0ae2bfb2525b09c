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

"""A gloo process group on the CPU for the port's mesh tests, and the
programs its ranks run. This module imports no jax: the rank processes
load only ``rayfed_tpu_torch``.

``run_ranks(world, program, payload)`` spawns ``world`` processes once;
each joins a gloo group, runs every case of ``program`` (a name in
``PROGRAMS``) in order and rank 0 hands back ``{case: result}``, where a
case that raised gives ``{"error": traceback}``. A test file spawns its
group once (a module-scoped fixture) and each of its tests reads one
case's result.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import pickle
import tempfile
import traceback
from datetime import timedelta

import numpy as np

from tests.utils import MP

#: Seconds a collective may wait before gloo gives up (a case that failed
#: on some ranks only then fails on the others too, instead of hanging).
COLLECTIVE_TIMEOUT_S = 300


def _rank_main(rank, world, port, program, payload, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    timeout = timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timeout)
    results = {}
    try:
        for name, case in PROGRAMS[program]:
            try:
                results[name] = case(payload)
            except Exception:  # noqa: BLE001 - reported to the test
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


def run_ranks(world: int, program: str, payload=None, timeout: float = 600):
    """Run ``program`` on ``world`` gloo ranks; rank 0's results. This
    process holds the group's store on a port the system picks, so no
    port is chosen first and bound later (another test's party could
    take it in between)."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                          wait_for_workers=False)
    port = store.port
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [MP.Process(target=_rank_main,
                            args=(r, world, port, program, payload, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join()
        path = os.path.join(out_dir, "rank0.pkl")
        if alive or not os.path.exists(path):
            raise AssertionError(
                f"{program}: ranks timed out or died (exit codes "
                f"{[p.exitcode for p in procs]})")
        with open(path, "rb") as f:
            return pickle.load(f)


@contextlib.contextmanager
def one_rank_mesh(names=("data", "model")):
    """A DeviceMesh of size 1 in each named dim over a one-rank gloo group
    in this process (destroyed on exit)."""
    import torch.distributed as dist

    from rayfed_tpu_torch import mesh as pm

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield pm.build_mesh(mesh_shape=[1] * len(names),
                            axis_names=list(names), device_type="cpu")
    finally:
        dist.destroy_process_group()


def case_result(results, name):
    """One case's result, or the failure of the case with its traceback."""
    res = results[name]
    if isinstance(res, dict) and "error" in res:
        raise AssertionError(f"case {name} failed on rank 0:\n{res['error']}")
    return res


# ---------------------------------------------------------------------------
# Helpers the programs share
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mesh(shape, names):
    """One DeviceMesh per shape and names for a program: every mesh opens
    gloo subgroups (sockets) that live until the group ends."""
    from rayfed_tpu_torch import mesh as pm

    return pm.build_mesh(mesh_shape=list(shape), axis_names=list(names),
                         device_type="cpu")


def _np(tree):
    """A tree of (D)Tensors as numpy arrays, every rank taking part."""
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.parallel import sharding as shd

    # A copy: the one-device step updates its tensors in place.
    from rayfed_tpu_torch import tree_util

    return tree_util.tree_map(lambda a: np.array(a, copy=True),
                              tfm.params_to_numpy(shd.gather_params(tree)))


def _raises(fn, exc):
    """The message of ``exc`` raised by ``fn``; None when it raised
    nothing (another type propagates)."""
    try:
        fn()
    except exc as e:  # noqa: PERF203
        return str(e)
    return None


# ---------------------------------------------------------------------------
# test_torch_sharding.py: 4 ranks
# ---------------------------------------------------------------------------

#: Mesh shapes the spec functions are held on (names, shape over 4 ranks).
SHARDING_MESHES = [
    (("data",), (4,)),
    (("data", "model"), (2, 2)),
    (("party", "data", "model"), (1, 2, 2)),
    (("party", "expert"), (4, 1)),
    (("party", "data", "seq"), (2, 2, 1)),
    (("model",), (4,)),
]


def _spec_functions(payload):
    from rayfed_tpu_torch.parallel import sharding as shd

    out = {}
    for names, shape in SHARDING_MESHES:
        m = _mesh(shape, names)
        out[names] = {
            "prune": [shd.prune_spec_to_mesh(spec, m)
                      for spec in payload["specs"]],
            "batch": shd.batch_spec(m),
            "batch_seq": shd.batch_spec(m, seq_axis="seq"),
            "batch_party_only": shd.batch_spec(m, data_axis=None),
        }
    return out


def _shard_params_roundtrip(payload):
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.parallel import sharding as shd

    m = _mesh((1, 2, 2), ("party", "data", "model"))
    out = {}
    for name, tree in payload["trees"].items():
        params = tfm.params_from_numpy(tree, "cpu")
        placed = shd.shard_params(m, params)
        full = shd.gather_params(placed)
        out[name] = {
            "bitwise": all(
                torch.equal(a, b) for a, b in zip(
                    tree_util.tree_flatten(full)[0],
                    tree_util.tree_flatten(params)[0])),
            "placements": {path: [str(p) for p in x.placements]
                           for path, x in shd.leaf_paths(placed)},
            "rules_placements": {
                path: [str(p) for p in pl] for path, pl in
                shd.leaf_paths(shd.make_param_shardings(m, params),
                               is_leaf=lambda x: isinstance(x, list))},
            "local_shapes": {path: tuple(x.to_local().shape)
                             for path, x in shd.leaf_paths(placed)},
        }
    return out


def _sequence_refusals(payload):
    """Attention over a sequence sharded across ranks is ring or Ulysses
    attention (item 13b): the flash op's DTensor rule and the dense
    attention both refuse it."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.parallel import sharding as shd

    tfm.register_dtensor_rules()
    m = _mesh((2, 2), ("data", "seq"))
    q = torch.randn(2, 32, 2, 16, generator=torch.Generator().manual_seed(0))
    qs = shd.place(q, m, [Shard(0), Shard(1)])
    qb = shd.place(q, m, [Shard(0), Replicate()])
    return {
        "flash": _raises(lambda: fa.flash_attention(qs, qs, qs),
                         NotImplementedError),
        "dense": _raises(lambda: tfm.causal_attention(qs, qs, qs),
                         NotImplementedError),
        # Batch-sharded, the same op runs on each rank's rows.
        "flash_batch": bool(torch.equal(
            fa.flash_attention(qb, qb, qb).full_tensor(),
            fa.flash_attention(q, q, q))),
    }


def _build_mesh_errors(payload):
    import torch.distributed as dist

    from rayfed_tpu_torch import mesh as pm

    return {
        "not_covered": _raises(
            lambda: pm.build_mesh(mesh_shape=[3], device_type="cpu"),
            ValueError),
        "expert": _raises(
            lambda: pm.build_mesh(mesh_shape=[2, 2],
                                  axis_names=["data", "expert"],
                                  device_type="cpu"), NotImplementedError),
        "default_names": list(pm.build_mesh(
            mesh_shape=[2, 2], device_type="cpu").mesh_dim_names),
        "subset": list(pm.build_mesh(
            device_ids=[0, 1], mesh_shape=[2], device_type="cpu"
        ).mesh_dim_names),
        # The group is up: a join that names another world size is
        # refused, one that names this rank of this world reuses it.
        "init_distributed_mismatch": _raises(
            lambda: pm.init_distributed("127.0.0.1:1", 2, 0), ValueError),
        "init_distributed": [
            pm.init_distributed("127.0.0.1:1", dist.get_world_size(),
                                dist.get_rank()),
            pm.party_group()["world"]],
    }


# ---------------------------------------------------------------------------
# test_torch_parallel.py: 8 ranks, party 2 x data 2 x model 2
# ---------------------------------------------------------------------------

PARALLEL_SHAPE = (2, 2, 2)
PARALLEL_NAMES = ("party", "data", "model")
LR = 1e-2


def _tiny_f32(**kw):
    import torch

    from rayfed_tpu_torch.models import transformer as tfm

    return tfm.tiny_config(compute_dtype=torch.float32, **kw)


def _steps(mesh_or_device, payload, n, **kw):
    """``n`` steps of ``make_fed_train_step`` from the payload's JAX init
    on its batch: {losses, params and gradient of the first step (its
    first AdamW moment over 1 - beta1) as numpy}, and the optimizer."""
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.parallel.train import Zero1AdamW, make_fed_train_step

    init_fn, step_fn = make_fed_train_step(
        kw.pop("cfg", None) or _tiny_f32(), mesh_or_device, lr=LR,
        attn=kw.pop("attn", "xla"), **kw)
    params, opt = init_fn(payload["init"])
    x, t = payload["inputs"], payload["targets"]
    out = {"losses": []}
    for i in range(n):
        params, opt, loss = step_fn(params, opt, x, t)
        out["losses"].append(float(loss))
        if i == 0:
            leaves, spec = tree_util.tree_flatten(params)
            held = opt.slices if isinstance(opt, Zero1AdamW) else leaves
            adam = opt.opt if isinstance(opt, Zero1AdamW) else opt
            beta1 = adam.param_groups[0]["betas"][0]
            out["params"] = _np(params)
            out["grads"] = tree_util.tree_map(
                lambda m: m / (1 - beta1), _np(tree_util.tree_unflatten(
                    [adam.state[h]["exp_avg"] for h in held], spec)))
    return out, opt


def _parallel_mesh():
    return _mesh(PARALLEL_SHAPE, PARALLEL_NAMES)


def _jax_steps(payload):
    """The sharded step's five losses, for the JAX package's."""
    return {"losses": _steps(_parallel_mesh(), payload, 5)[0]["losses"]}


def _against(mesh, payload, n, ref_mesh_or_device, **kw):
    """``n`` steps over ``mesh`` with ``kw`` against ``n`` plain ones on
    ``ref_mesh_or_device`` (``want``) and, when that is the mesh, on one
    device (``one_device``); the optimizer of the first."""
    got, opt = _steps(mesh, payload, n, **kw)
    out = {"got": got, "want": _steps(ref_mesh_or_device, payload, n)[0]}
    if ref_mesh_or_device is mesh:
        out["one_device"] = _steps("cpu", payload, n)[0]
    return out, opt


def _sharded_vs_unsharded(payload):
    return _against(_parallel_mesh(), payload, 5, "cpu")[0]


def _accum(payload):
    m = _parallel_mesh()
    return _against(m, payload, 2, m, accum_steps=2)[0]


def _accum_errors(payload):
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    m = _parallel_mesh()
    cfg = _tiny_f32()
    zero = _raises(lambda: make_fed_train_step(cfg, m, accum_steps=0),
                   ValueError)
    out = {"zero": zero}
    # 8 rows over party x data: 2 a rank. accum_steps=3 divides neither
    # the batch nor a rank's rows; 4 divides the batch, not a rank's rows.
    for accum in (3, 4):
        init_fn, step_fn = make_fed_train_step(cfg, m, accum_steps=accum)
        params, opt = init_fn(payload["init"])
        out[accum] = _raises(
            lambda: step_fn(params, opt, payload["inputs"],
                            payload["targets"]), ValueError)
    return out


def _zero1(payload):
    from torch.distributed.tensor import Shard

    m = _parallel_mesh()
    out, opt = _against(m, payload, 3, m, shard_opt_state=True)
    dp_dims = {0, 1}
    out["dp_sharded_moments"] = [
        [str(p) for p in mom.placements] for mom in opt.moments()
        if any(isinstance(p, Shard) for i, p in enumerate(mom.placements)
               if i in dp_dims)]
    out["moments"] = len(opt.moments())
    return out


def _donate(payload):
    """``donate=False`` over the mesh leaves the given params and
    optimizer untouched and returns what ``donate=True`` returns, with
    replicated and with ZeRO-1 moments."""
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    m = _parallel_mesh()
    x, t = payload["inputs"], payload["targets"]
    out = {}
    for name, kw in (("replicated", {}), ("zero1", {"shard_opt_state": True})):
        results = []
        for donate in (True, False):
            init_fn, step_fn = make_fed_train_step(
                _tiny_f32(), m, lr=LR, attn="xla", donate=donate, **kw)
            params, opt = init_fn(payload["init"])
            params, opt, _ = step_fn(params, opt, x, t)
            before = _np(params)
            new, new_opt, _ = step_fn(params, opt, x, t)
            results.append((before, _np(params), _np(new),
                            new is params, new_opt is opt))
        (_, _, donated, same_p, same_o), (before, after, new, fresh_p,
                                          fresh_o) = results
        flat = tree_util.tree_flatten
        out[name] = {
            "in_place": same_p and same_o,
            "fresh": not fresh_p and not fresh_o,
            "untouched": all(np.array_equal(a, b) for a, b in zip(
                flat(before)[0], flat(after)[0])),
            "equal": all(np.array_equal(a, b) for a, b in zip(
                flat(donated)[0], flat(new)[0])),
        }
    return out


def _flash_heads(payload):
    """The flash path's plain versions on the mesh: the heads and batch
    rows each call sees, and the step against the unsharded flash step."""
    from rayfed_tpu_torch.ops import flash_attention as fa

    seen = []
    plain = fa._flash_fwd_plain

    def spy(q, k, v, *args):
        seen.append(tuple(q.shape))
        return plain(q, k, v, *args)

    fa._flash_fwd_plain = spy
    try:
        got, _ = _steps(_parallel_mesh(), payload, 2, attn="flash")
    finally:
        fa._flash_fwd_plain = plain
    want, _ = _steps("cpu", payload, 2, attn="flash")
    return {"shapes": sorted(set(seen)), "got": got, "want": want}


def _remat(payload):
    """Each remat mode over the mesh with the flash path: its losses
    against the one-device step's, and the flash forwards a step runs
    (``remat="attn"`` must find the flash op by name under DTensor and
    keep its outputs, so the backward runs no forward again)."""
    from rayfed_tpu_torch.ops import flash_attention as fa

    calls = [0]
    plain = fa._flash_fwd_plain

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    out = {}
    for remat in (False, True, "attn"):
        fa._flash_fwd_plain = counted
        calls[0] = 0
        try:
            got, _ = _steps(_parallel_mesh(), payload, 1, attn="flash",
                            remat=remat)
        finally:
            fa._flash_fwd_plain = plain
        want, _ = _steps("cpu", payload, 1, attn="flash", remat=remat)
        out[str(remat)] = {"forwards": calls[0], "losses": got["losses"],
                           "ref_losses": want["losses"]}
    return out


def _moe(payload):
    """An MoE model over the mesh (its experts replicated until item
    13b) against the one-device step, from the same fresh params."""
    import torch

    from rayfed_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_config(compute_dtype=torch.float32, n_experts=4)
    moe_payload = dict(payload, init=tfm.params_to_numpy(
        tfm.init_params(3, cfg, "cpu")))
    got, _ = _steps(_parallel_mesh(), moe_payload, 2, cfg=cfg)
    want, _ = _steps("cpu", moe_payload, 2, cfg=cfg)
    return {"got": got, "want": want}


def _parallel_refusals(payload):
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    cfg = _tiny_f32()
    seq_mesh = _mesh((2, 2, 2), ("party", "data", "seq"))
    return {
        "seq": _raises(lambda: make_fed_train_step(cfg, seq_mesh,
                                                   seq_axis="seq"),
                       NotImplementedError),
        "seq_parallel": _raises(
            lambda: make_fed_train_step(cfg, seq_mesh, seq_parallel="x"),
            ValueError),
        # A seq dim of size 1 shards nothing: the step builds.
        "seq_one": make_fed_train_step(
            cfg, _mesh((2, 4, 1), ("party", "data", "seq")),
            seq_axis="seq") is not None,
    }


# ---------------------------------------------------------------------------
# test_torch_sharded_decode.py: 4 ranks, data 2 x model 2
# ---------------------------------------------------------------------------


def _decode_mesh():
    return _mesh((2, 2), ("data", "model"))


def _decode_cases(payload):
    import torch

    from rayfed_tpu_torch.models import decode, speculative
    from rayfed_tpu_torch.models import transformer as tfm

    m = _decode_mesh()
    out = {}
    for name, case in payload.items():
        cfg = tfm.tiny_config(compute_dtype=torch.float32, **case["cfg"])
        params = tfm.params_from_numpy(case["params"], "cpu")
        prompt = torch.from_numpy(case["prompt"])
        if name == "generate":
            def make(mesh):
                return decode.make_generate_fn(cfg, max_new_tokens=5,
                                               mesh=mesh)

            def call(fn):
                return fn(params, prompt)
        elif name == "beam":
            def make(mesh):
                return decode.make_beam_search_fn(
                    cfg, max_new_tokens=4, n_beams=3, eos_id=0, mesh=mesh)

            def call(fn):
                return fn(params, prompt)
        else:
            dcfg = tfm.tiny_config(compute_dtype=torch.float32,
                                   **case["dcfg"])
            dparams = tfm.params_from_numpy(case["dparams"], "cpu")
            kw = dict(case["kw"])
            rng = kw.pop("rng", None)

            def make(mesh, kw=kw, dcfg=dcfg):
                return speculative.make_speculative_generate_fn(
                    cfg, dcfg, mesh=mesh, return_stats=True, **kw)

            def call(fn, dparams=dparams, rng=rng):
                return fn(params, dparams, prompt, rng)
        got = call(make(m))
        want = call(make(None))
        if name == "beam":
            out[name] = {"seqs": got[0].numpy(), "scores": got[1].numpy(),
                         "ref_seqs": want[0].numpy(),
                         "ref_scores": want[1].numpy()}
        elif name.startswith("speculative"):
            out[name] = {"tokens": got[0].numpy(), "rounds": got[1],
                         "ref_tokens": want[0].numpy(),
                         "ref_rounds": want[1]}
        else:
            out[name] = {"tokens": got.numpy(), "ref_tokens": want.numpy()}
    return out


def _decode_lora_tree(payload):
    """A second, LoRA-merged tree through the same sharded generate: its
    own placements, its own tokens (those of the unsharded run)."""
    import torch

    from rayfed_tpu_torch.models import decode, lora
    from rayfed_tpu_torch.models import transformer as tfm

    case = payload["generate"]
    cfg = tfm.tiny_config(compute_dtype=torch.float32, **case["cfg"])
    params = tfm.params_from_numpy(case["params"], "cpu")
    ad = lora.init_lora(7, cfg, rank=2, device="cpu")
    ad["layers"] = {t: {"a": ab["a"], "b": ab["b"] + 0.05}
                    for t, ab in ad["layers"].items()}
    merged = lora.merge_lora(params, ad)
    prompt = torch.from_numpy(case["prompt"])
    gen = decode.make_generate_fn(cfg, max_new_tokens=5, mesh=_decode_mesh())
    ref = decode.make_generate_fn(cfg, max_new_tokens=5)
    return {"base": gen(params, prompt).numpy(),
            "merged": gen(merged, prompt).numpy(),
            "ref_base": ref(params, prompt).numpy(),
            "ref_merged": ref(merged, prompt).numpy()}


PROGRAMS = {
    "sharding": [
        ("spec_functions", _spec_functions),
        ("shard_params", _shard_params_roundtrip),
        ("sequence", _sequence_refusals),
        ("build_mesh", _build_mesh_errors),
    ],
    "parallel": [
        ("jax_steps", _jax_steps),
        ("sharded_vs_unsharded", _sharded_vs_unsharded),
        ("accum", _accum),
        ("accum_errors", _accum_errors),
        ("zero1", _zero1),
        ("donate", _donate),
        ("flash_heads", _flash_heads),
        ("remat", _remat),
        ("moe", _moe),
        ("refusals", _parallel_refusals),
    ],
    "decode": [
        ("decode", _decode_cases),
        ("lora", _decode_lora_tree),
    ],
}

WORLD = {"sharding": 4, "parallel": math.prod(PARALLEL_SHAPE), "decode": 4}


# ---------------------------------------------------------------------------
# Multi-process parties: alice over two processes, bob in one
# (test_torch_multihost_party.py)
# ---------------------------------------------------------------------------

#: Seconds a party process's program may take (each of its waits has a
#: shorter deadline of its own: RELAY_RECV_MS, the group's timeout).
PARTY_TIMEOUT_S = 120
#: The job's receive deadline, which the relay and the party group take.
RELAY_RECV_MS = 60_000
#: (party, process id) of each process of the multi-process job.
PARTY_ROLES = [("alice", 0), ("alice", 1), ("bob", 0)]


def _party_main(party, pid, program, payload, addresses, coordinator, kv_dir,
                out_path):
    import torch

    torch.set_num_threads(1)
    try:
        res = PARTY_PROGRAMS[program](party, pid, payload, addresses,
                                      coordinator, kv_dir)
    except Exception:  # noqa: BLE001 - reported to the test
        res = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def run_party_processes(program: str, payload=None, roles=PARTY_ROLES,
                        timeout: float = PARTY_TIMEOUT_S):
    """Run the fed program ``program`` (a name in ``PARTY_PROGRAMS``) in
    one spawned process per ``(party, process id)`` of ``roles``, alice's
    processes one party over a gloo group; {(party, pid): result}, where
    a program that raised gives ``{"error": traceback}``."""
    from tests.utils import get_addresses

    addresses = get_addresses(sorted({p for p, _ in roles}))
    coordinator = get_addresses(["coord"])["coord"]
    with tempfile.TemporaryDirectory() as tmp:
        outs = {r: os.path.join(tmp, f"{r[0]}-{r[1]}.pkl") for r in roles}
        procs = {r: MP.Process(target=_party_main, args=(
            r[0], r[1], program, payload, addresses, coordinator, tmp,
            outs[r])) for r in roles}
        for p in procs.values():
            p.start()
        for p in procs.values():
            p.join(timeout=timeout)
        alive = [r for r, p in procs.items() if p.is_alive()]
        for r in alive:
            procs[r].terminate()
            procs[r].join()
        missing = [r for r in roles if not os.path.exists(outs[r])]
        if alive or missing:
            raise AssertionError(
                f"{program}: processes {alive} timed out, {missing} left no "
                f"result (exit codes "
                f"{ {r: p.exitcode for r, p in procs.items()} })")
        out = {}
        for r in roles:
            with open(outs[r], "rb") as f:
                out[r] = pickle.load(f)
        return out


def party_result(results, role):
    """One process's result, or its failure with the traceback."""
    res = results[role]
    if isinstance(res, dict) and "error" in res:
        raise AssertionError(f"process {role} failed:\n{res['error']}")
    return res


def _digest(tree):
    """Each tensor leaf's dtype, shape and bytes (a DTensor's local part)."""
    import hashlib

    import torch
    from torch.distributed.tensor import DTensor

    from rayfed_tpu_torch import tree_util

    out = []
    for x in tree_util.tree_flatten(tree)[0]:
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        if isinstance(x, DTensor):
            x = x.to_local()
        x = x.detach().cpu().contiguous()
        raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        out.append((str(x.dtype), tuple(x.shape),
                    hashlib.sha256(raw.numpy().tobytes()).hexdigest()))
    return out


def _relay_tree():
    """bob's pushed tree: f32, bf16 and int64 leaves and a scalar; 10 MiB
    in all, so the relay carries it point to point (past
    ``STORE_INLINE``)."""
    import torch

    g = torch.Generator().manual_seed(7)
    return {"w": torch.randn(640, 4096, generator=g),
            "bf16": torch.randn(3, 130, generator=g).to(torch.bfloat16),
            "nested": [torch.arange(12, dtype=torch.int64).reshape(3, 4),
                       {"b": torch.randn(5, generator=g)}],
            "step": 3}


def _multihost(party, pid, payload, addresses, coordinator, kv_dir):
    """One process of the multi-process job. alice runs as two processes
    (leader 0, follower 1) joined by ``config["jax_distributed"]`` over a
    gloo group with a ``data = 2`` party mesh on the CPU; bob as one."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh as fed_mesh
    from rayfed_tpu_torch import tracing
    from rayfed_tpu_torch.exceptions import FedRemoteError
    from rayfed_tpu_torch.privacy.manager import get_privacy_manager
    from rayfed_tpu_torch.proxy import barriers
    from tests.utils import FAST_COMM_CONFIG

    cfg = {"cross_silo_comm": dict(
               FAST_COMM_CONFIG, recv_timeout_in_ms=RELAY_RECV_MS,
               continue_waiting_for_data_sending_on_error=True),
           "privacy": {"secure_aggregation": True, "mask_seed": 11}}
    if party == "alice":
        cfg["jax_distributed"] = {"coordinator_address": coordinator,
                                  "num_processes": 2, "process_id": pid}
        cfg["kv_store"] = {"backend": "file", "path": kv_dir}
        cfg["party_mesh"] = {"mesh_shape": [2], "axis_names": ["data"],
                             "device_type": "cpu"}
    tracing.enable()
    fed.init(addresses=addresses, party=party, config=cfg)
    out = {"leader": fed.is_party_leader(),
           "proxies": (barriers.sender_proxy() is not None,
                       barriers.receiver_proxy() is not None),
           "privacy_plane": get_privacy_manager() is not None}
    if party == "alice":
        from rayfed_tpu_torch.config import PartyMeshConfig

        group = fed_mesh.party_group()
        m = fed_mesh.get_party_mesh()
        out.update(backend=group["backend"], world=group["world"],
                   mesh=dict(zip(m.mesh_dim_names, m.shape)))
        # The party mesh's other forms over the same group, then the
        # job's again.
        out["mesh_forms"] = {}
        for form, mcfg in (("device_ids", {"device_ids": [0, 1]}),
                           ("mesh_shape", {"mesh_shape": [2, 1],
                                           "axis_names": ["data", "model"]})):
            m2 = fed_mesh.init_party_mesh(PartyMeshConfig.from_dict(
                dict(mcfg, device_type="cpu")))
            out["mesh_forms"][form] = dict(zip(m2.mesh_dim_names, m2.shape))
        fed_mesh.init_party_mesh(PartyMeshConfig.from_dict(
            cfg["party_mesh"]))

    # The mirror of tests/test_multihost_party.py: a computation whose
    # all-reduce spans both of alice's processes, consumed at bob.
    @fed.remote
    def train_step():
        x = torch.tensor([10.0 * (dist.get_rank() + 1)])
        dist.all_reduce(x)
        return float(x)

    @fed.remote
    def consume(v):
        assert v == 30.0, v
        return v * 2

    out["aggregate"] = fed.get(consume.party("bob").remote(
        train_step.party("alice").remote()))

    @fed.remote
    def produce():
        return torch.arange(8, dtype=torch.float32)

    @fed.remote
    def consume_on_alice(arr):
        return float(arr.sum())

    out["inbound"] = fed.get(consume_on_alice.party("alice").remote(
        produce.party("bob").remote()))

    # The relay of a tree, bitwise, placed on the party mesh.
    @fed.remote
    def bob_tree():
        return _relay_tree()

    @fed.remote
    def held(tree):
        leaves = [x for x in [tree["w"], tree["bf16"], tree["nested"][0]]]
        return {"digest": _digest(tree), "step": tree["step"],
                "replicated": all(isinstance(x, DTensor) and all(
                    isinstance(p, Replicate) for p in x.placements)
                    for x in leaves)}

    tree = bob_tree.party("bob").remote()
    out["held"] = fed.get(held.party("alice").remote(tree))
    out["sent_digest"] = _digest(_relay_tree())

    # alice pushes to bob: one frame an edge, the leader's.
    @fed.remote
    def alice_tree():
        return {"a": torch.full((4, 4), float(dist.get_rank() == 0))}

    @fed.remote
    def bob_reads(tree):
        return float(tree["a"].sum())

    out["alice_push"] = fed.get(bob_reads.party("bob").remote(
        alice_tree.party("alice").remote()))

    # A tree sharded by the rules over a data x model = 1 x 2 mesh of
    # alice's processes: placed by the rules, pushed as ``sharr`` (the
    # follower hands the leader its shards), decoded whole at bob.
    @fed.remote
    def sharded_tree():
        tm = _mesh((1, 2), ("data", "model"))
        return fed_mesh.place_received(_sharded_source(), mesh=tm)

    @fed.remote
    def whole_digest(tree):
        return _digest(tree)

    @fed.remote
    def local_shapes(tree):
        from rayfed_tpu_torch.parallel import sharding as shd

        return {path: [tuple(v.to_local().shape), tuple(v.shape),
                       [type(p).__name__ + str(getattr(p, "dim", ""))
                        for p in v.placements]]
                for path, v in shd.leaf_paths(tree)}

    sharded = sharded_tree.party("alice").remote()
    out["sharded_shapes"] = fed.get(local_shapes.party("alice").remote(
        sharded))
    out["sharded_at_bob"] = fed.get(whole_digest.party("bob").remote(sharded))

    @fed.remote
    def sharded_wire():
        """The leader's ``sharr`` encoding of the same tree, the
        follower's shards gathered through the store."""
        from rayfed_tpu_torch._private import serialization

        tm = _mesh((1, 2), ("data", "model"))
        tree = fed_mesh.place_received(_sharded_source(), mesh=tm)
        key = "fedtpu_shards:test:wire:0"
        if pid != 0:
            barriers._post_shards_at_resolution(tree, key)
            return None
        kind, meta, bufs = serialization.encode_payload(
            barriers._gather_shards(tree, key))
        return {"kind": kind, "meta": meta,
                "payload": b"".join(bytes(b) for b in bufs)}

    # Each of alice's processes gets its own result: the leader's is the
    # encoding.
    out["sharr"] = fed.get(sharded_wire.party("alice").remote())
    out["full_digest"] = _digest(_sharded_source())

    # The data = 2 train step over the party mesh.
    @fed.remote
    def dp_steps():
        from rayfed_tpu_torch.parallel import sharding as shd

        init_fn, step_fn = _steps_fn(fed_mesh.get_party_mesh())
        params, opt = init_fn(payload["init"])
        losses = []
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, payload["inputs"],
                                        payload["targets"])
            losses.append(float(loss))
        return {"losses": losses,
                "digest": _digest(shd.gather_params(params))}

    out["dp"] = fed.get(dp_steps.party("alice").remote())
    # An error at bob reaches both of alice's processes.
    @fed.remote
    def boom():
        raise ValueError("bob's task failed")

    @fed.remote
    def after(x):
        return x

    try:
        fed.get(after.party("alice").remote(boom.party("bob").remote()))
        out["remote_error"] = None
    except FedRemoteError as e:
        out["remote_error"] = ("FedRemoteError", str(e))
    except ValueError as e:  # bob's own task raises at bob
        out["remote_error"] = ("ValueError", str(e))

    if party == "bob":
        out["frames"] = [
            (s.upstream_seq_id, s.downstream_seq_id)
            for s in tracing.get_spans("decode") if s.peer == "alice"]
    if party == "alice":
        # Every follower's gets have returned, so each has acked.
        dist.monitored_barrier(timeout=timedelta(seconds=PARTY_TIMEOUT_S))
        if pid == 0:
            out["relayed"] = len(barriers.relay_stats())
            out["keys_left"] = barriers.relay_keys_left()
    out["relay"] = barriers.relay_stats()
    fed.shutdown()
    # The party group outlives fed.shutdown; the process is done with it.
    fed_mesh.shutdown_distributed()
    return out


def _sharded_source():
    """The tiny model's leaves that the rules shard over ``model`` (``wq``
    on its output features, ``w_down`` on its input) and one they
    replicate (``embed``), as plain tensors."""
    from rayfed_tpu_torch.models import transformer as tfm

    params = tfm.init_params(0, _tiny_f32(), "cpu")
    return {"layers": {"wq": params["layers"]["wq"],
                       "w_down": params["layers"]["w_down"]},
            "embed": params["embed"]}


def _steps_fn(mesh_or_device):
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    return make_fed_train_step(_tiny_f32(), mesh_or_device, lr=LR,
                               attn="xla")


def _rejoin(party, pid, payload, addresses, coordinator, kv_dir):
    """One of alice's two processes in a one-party job, run twice: the
    first ``fed.init`` joins the party group, ``fed.shutdown`` leaves it
    up and the second ``fed.init`` reuses it; a task's all-reduce spans
    both processes each time. ``shutdown_distributed`` then destroys
    it."""
    import torch
    import torch.distributed as dist

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh as fed_mesh
    from tests.utils import FAST_COMM_CONFIG

    cfg = {"cross_silo_comm": dict(FAST_COMM_CONFIG,
                                   recv_timeout_in_ms=RELAY_RECV_MS),
           "jax_distributed": {"coordinator_address": coordinator,
                               "num_processes": 2, "process_id": pid},
           "party_mesh": {"mesh_shape": [2], "axis_names": ["data"],
                          "device_type": "cpu"}}

    @fed.remote
    def total(k):
        x = torch.tensor([float(k * (dist.get_rank() + 1))])
        dist.all_reduce(x)
        return float(x)

    out = {"runs": []}
    for k in (1, 10):
        fed.init(addresses={"alice": addresses["alice"]}, party=party,
                 config=cfg)
        group = fed_mesh.party_group()
        out["runs"].append(dict(
            total=fed.get(total.party("alice").remote(k)),
            world=group["world"], owned=group["owned"],
            store=id(group["store"])))
        fed.shutdown()
        out["runs"][-1]["up"] = fed_mesh.party_group() is group
    fed_mesh.shutdown_distributed()
    out["left"] = (fed_mesh.party_group() is None
                   and not dist.is_initialized())
    return out


PARTY_PROGRAMS = {"multihost": _multihost, "rejoin": _rejoin}

__all__ = ["run_ranks", "case_result", "one_rank_mesh", "PROGRAMS", "WORLD",
           "run_party_processes", "party_result", "PARTY_PROGRAMS"]
