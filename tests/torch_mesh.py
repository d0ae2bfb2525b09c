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
        "init_distributed": _raises(
            lambda: pm.init_distributed("127.0.0.1:1", 2, 0),
            NotImplementedError),
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

__all__ = ["run_ranks", "case_result", "one_rank_mesh", "PROGRAMS", "WORLD"]
