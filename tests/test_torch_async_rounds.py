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

"""The port's asynchronous buffered aggregation (``rayfed_tpu_torch.
async_rounds``) on torch trees: the mirrors of ``tests/test_async_rounds.py``
(staleness decay, K-publish cadence, liveness filtering, the bitwise
determinism contract, the offer-time snapshot, the driver surface, and
two spawned two-party runs under a seeded straggler schedule), plus:

- the port's aggregator and the JAX package's fed the same numpy-seeded
  offers, weights and arrival order publish the same bits at every
  version, with a SUSPECT down-weight, a DEAD drop and a stale offer;
- a driver that mutates its tensor in place after ``offer()`` leaves the
  buffered contribution as it was;
- a mixed-package async round over localhost TCP: a JAX party offers to
  a torch root and a torch party to a JAX root, and each root's version
  equals the other package's fold of the same arrivals bitwise;
- secure async offers raise, naming ROADMAP item 11.
"""

import pickle
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import topology as topo
from rayfed_tpu_torch.async_rounds import (
    BufferedAggregator,
    async_round,
    resolve_staleness_fn,
)
from rayfed_tpu_torch.config import AsyncAggregationConfig
from rayfed_tpu_torch.ops.aggregate import reduce_by_plan, tree_mix
from rayfed_tpu_torch.resilience.liveness import DEAD, SUSPECT, state_weight
from tests.utils import FAST_COMM_CONFIG, get_addresses, run_parties

torch.set_num_threads(2)


def _bits(x):
    """A leaf's bytes: torch (bf16 through int16), jax or numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Staleness decay + config validation
# ---------------------------------------------------------------------------


def test_staleness_fns():
    poly = resolve_staleness_fn("poly", exp=0.5)
    assert poly(0) == 1.0
    np.testing.assert_allclose(poly(1), 2.0 ** -0.5)
    np.testing.assert_allclose(poly(3), 0.5)
    const = resolve_staleness_fn("constant")
    assert const(0) == const(7) == 1.0
    expf = resolve_staleness_fn("exp", exp=0.5)
    np.testing.assert_allclose(expf(2), 0.25)
    f = lambda s: 42.0  # noqa: E731
    assert resolve_staleness_fn(f) is f
    with pytest.raises(ValueError, match="0 < async_staleness_exp"):
        resolve_staleness_fn("exp", exp=1.5)
    with pytest.raises(ValueError, match="poly"):
        resolve_staleness_fn("linear")


def test_async_config_from_aggregation_dict():
    cfg = AsyncAggregationConfig.from_aggregation_dict(
        {"async_buffer_k": 4, "async_staleness": "exp",
         "async_staleness_exp": 0.9, "topology": "tree"}
    )
    assert cfg.buffer_k == 4 and cfg.staleness == "exp"
    assert AsyncAggregationConfig(**cfg.as_dict()) == cfg
    with pytest.raises(ValueError, match="async_bufer_k"):
        AsyncAggregationConfig.from_aggregation_dict({"async_bufer_k": 2})


@pytest.mark.parametrize("kwargs", [
    dict(buffer_k=0), dict(server_lr=0.0), dict(server_lr=1.5),
    dict(suspect_factor=-0.1), dict(max_staleness=-1),
    dict(staleness="linear")],
    ids=["buffer_k", "lr0", "lr15", "suspect", "max_staleness", "staleness"])
def test_async_config_validates_ranges(kwargs):
    with pytest.raises(ValueError):
        AsyncAggregationConfig(**kwargs)


# ---------------------------------------------------------------------------
# BufferedAggregator on torch trees
# ---------------------------------------------------------------------------


def _tree(v, n=8):
    return {"g": torch.full((n,), float(v), dtype=torch.float32)}


def test_publishes_every_k_contributions():
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=2, staleness="constant"))
    st = agg.offer("alice", _tree(1.0), round_tag=0)
    assert st["accepted"] and st["version"] == 0 and st["buffered"] == 1
    assert agg.current()["params"] is None
    st = agg.offer("bob", _tree(3.0), round_tag=0)
    assert st["version"] == 1 and st["published"] == 1
    cur = agg.current()
    assert cur["version"] == 1 and isinstance(cur["params"]["g"], torch.Tensor)
    np.testing.assert_allclose(_np(cur["params"]["g"]), 2.0)
    st = agg.offer("alice", _tree(5.0), round_tag=1)
    assert st["buffered"] == 1 and st["version"] == 1
    s = agg.snapshot_stats()
    assert s["accepted"] == 3 and s["publishes"] == 1
    assert s["latest_round_tag"] == 1 and s["buffered"] == 1


def test_staleness_weight_math_matches_fedbuff():
    agg = BufferedAggregator(AsyncAggregationConfig(
        buffer_k=2, staleness="poly", staleness_exp=0.5))
    st = agg.offer("alice", _tree(5.0), round_tag=1)
    assert st["staleness"] == 0 and st["weight"] == 1.0
    st = agg.offer("bob", _tree(1.0), round_tag=0)
    w = 2.0 ** -0.5
    assert st["staleness"] == 1
    np.testing.assert_allclose(st["weight"], w)
    np.testing.assert_allclose(_np(agg.current()["params"]["g"]),
                               np.float32((5.0 + w) / (1.0 + w)), rtol=1e-6)


def test_dead_dropped_suspect_downweighted():
    view = {"bob": SUSPECT, "carol": DEAD}
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=2, staleness="constant",
                               suspect_factor=0.5),
        liveness_fn=lambda: view)
    st = agg.offer("carol", _tree(100.0), round_tag=0)
    assert not st["accepted"] and st["reason"] == "dead"
    agg.offer("alice", _tree(2.0), round_tag=0)
    st = agg.offer("bob", _tree(4.0), round_tag=0)
    assert st["weight"] == state_weight(SUSPECT, 0.5) == 0.5
    np.testing.assert_allclose(_np(agg.current()["params"]["g"]),
                               np.float32(8.0 / 3.0), rtol=1e-6)
    assert agg.snapshot_stats()["dropped_dead"] == 1


def test_max_staleness_drops_ancient_contributions():
    agg = BufferedAggregator(AsyncAggregationConfig(
        buffer_k=10, staleness="constant", max_staleness=1))
    agg.offer("alice", _tree(1.0), round_tag=5)
    st = agg.offer("bob", _tree(9.0), round_tag=3)
    assert not st["accepted"] and st["reason"] == "stale"
    assert agg.snapshot_stats()["dropped_stale"] == 1
    assert agg.snapshot_stats()["buffered"] == 1


def _seeded_trees(n, seed=7, dtype="float32"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = {"w": rng.standard_normal((33, 17)).astype(np.float32),
             "b": (rng.standard_normal(7) * 100).astype(np.float32)}
        if dtype == "bfloat16":
            t = {k: v.astype(ml_dtypes.bfloat16) for k, v in t.items()}
        out.append(t)
    return out


def _jax_tree(t):
    # jax arrays, as a JAX party holds them (the JAX package's fold of
    # numpy bf16 leaves returns float32).
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in t.items()}


def _torch_tree(t):
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())

    return {k: leaf(v) for k, v in t.items()}


def test_fixed_arrival_order_replays_bitwise():
    trees = [_torch_tree(t) for t in _seeded_trees(6)]
    arrivals = [("alice", 0), ("bob", 0), ("alice", 1), ("carol", 0),
                ("bob", 2), ("carol", 1)]

    def run():
        agg = BufferedAggregator(AsyncAggregationConfig(
            buffer_k=3, staleness="poly", server_lr=0.5))
        for (party, tag), t in zip(arrivals, trees):
            agg.offer(party, t, round_tag=tag)
        return agg.current()

    a, b = run(), run()
    assert a["version"] == b["version"] == 2
    for k in a["params"]:
        assert _bits(a["params"][k]) == _bits(b["params"][k])


def test_arrival_order_fold_matches_reduce_by_plan():
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=3, staleness="constant"))
    g = torch.Generator().manual_seed(3)
    trees = [{"w": torch.randn((9, 5), generator=g)} for _ in range(3)]
    for i, t in enumerate(trees):
        agg.offer("alice" if i % 2 == 0 else "bob", t, round_tag=0,
                  weight=float(i + 1))
    slots = [f"{'alice' if i % 2 == 0 else 'bob'}#{i}" for i in range(3)]
    ref = reduce_by_plan(topo.plan_buffer(slots), dict(zip(slots, trees)),
                         weights={s: float(i + 1) for i, s in enumerate(slots)})
    assert _bits(agg.current()["params"]["w"]) == _bits(ref["w"])


def test_psum_path_bitwise_matches_fold_path():
    # The JAX package lowers a buffer of distinct parties that compose
    # onto a registered party mesh to one psum, bitwise equal to its
    # arrival-order fold; that same-mesh lane is ROADMAP item 12, so the
    # port always folds in arrival order and must give that fold's bits,
    # which the JAX package's aggregator computes without a mesh.
    from rayfed_tpu import async_rounds as jasync
    from rayfed_tpu import config as jconfig

    parties = ["p0", "p1", "p2", "p3"]
    rng = np.random.default_rng(11)
    trees = {p: {"w": rng.standard_normal((17, 3)).astype(np.float32)}
             for p in parties}

    def run(cls, cfg_cls, convert):
        agg = cls(cfg_cls(buffer_k=4, staleness="constant"))
        for i, p in enumerate(parties):
            agg.offer(p, convert(trees[p]), round_tag=0,
                      weight=float(2 * i + 1))
        return agg.current()["params"]

    torch_bits = _bits(run(BufferedAggregator, AsyncAggregationConfig,
                           _torch_tree)["w"])
    jax_bits = _bits(run(jasync.BufferedAggregator,
                         jconfig.AsyncAggregationConfig, _jax_tree)["w"])
    assert torch_bits == jax_bits


def test_offer_snapshots_mutable_leaves():
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=2, staleness="constant"))
    mine = torch.full((8,), 1.0)
    agg.offer("alice", {"g": mine}, round_tag=0)
    mine += 1000.0  # round t+1 reuses the buffer in place
    agg.offer("bob", _tree(3.0), round_tag=0)
    np.testing.assert_allclose(_np(agg.current()["params"]["g"]), 2.0)


def test_publish_cb_failure_does_not_poison_aggregation():
    calls = []

    def cb(version, params):
        calls.append(version)
        if version == 1:
            raise RuntimeError("downstream serving hiccup")

    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=1, staleness="constant"),
        publish_cb=cb)
    st = agg.offer("alice", _tree(1.0), round_tag=0)
    assert st["accepted"] and st["version"] == 1
    agg.offer("alice", _tree(3.0), round_tag=1)
    s = agg.snapshot_stats()
    assert s["publishes"] == 2 and s["publish_errors"] == 1
    assert calls == [1, 2]


def test_server_lr_mixes_into_previous_model():
    agg = BufferedAggregator(AsyncAggregationConfig(
        buffer_k=1, staleness="constant", server_lr=0.5))
    agg.offer("alice", _tree(4.0), round_tag=0)
    np.testing.assert_allclose(_np(agg.current()["params"]["g"]), 4.0)
    agg.offer("alice", _tree(8.0), round_tag=1)
    np.testing.assert_allclose(_np(agg.current()["params"]["g"]), 6.0)


def test_tree_mix_identities_and_math():
    new = {"g": torch.full((4,), 8.0)}
    assert tree_mix(None, new, 0.5) is new
    old = {"g": torch.full((4,), 4.0)}
    assert tree_mix(old, new, 1.0) is new
    out = tree_mix(old, new, 0.25)
    np.testing.assert_allclose(_np(out["g"]), 5.0)
    assert out["g"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Held against the JAX package's aggregator, and the in-place mutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,server_lr", [("float32", 1.0),
                                             ("float32", 0.5),
                                             ("bfloat16", 0.5)])
def test_aggregator_versions_bitwise_equal_the_jax_package(dtype, server_lr):
    from rayfed_tpu import async_rounds as jasync
    from rayfed_tpu import config as jconfig
    from rayfed_tpu.resilience import liveness as jliveness

    view = {"bob": SUSPECT, "dave": DEAD}
    jview = {"bob": jliveness.SUSPECT, "dave": jliveness.DEAD}
    trees = _seeded_trees(9, seed=5, dtype=dtype)
    # (party, round tag, weight): a SUSPECT party, a DEAD one, stale tags.
    arrivals = [("alice", 0, 3.0), ("bob", 0, 1.0), ("dave", 0, 2.0),
                ("carol", 1, 0.37), ("alice", 2, 1.0), ("bob", 1, 1000.5),
                ("carol", 0, 1.7), ("alice", 3, 1.0), ("bob", 3, 2.0)]
    kw = dict(buffer_k=2, staleness="poly", server_lr=server_lr,
              suspect_factor=0.37)
    port = BufferedAggregator(AsyncAggregationConfig(**kw),
                              liveness_fn=lambda: view)
    ref = jasync.BufferedAggregator(jconfig.AsyncAggregationConfig(**kw),
                                    liveness_fn=lambda: jview)
    published = 0
    for (party, tag, w), t in zip(arrivals, trees):
        got = port.offer(party, _torch_tree(t), round_tag=tag, weight=w)
        want = ref.offer(party, _jax_tree(t), round_tag=tag, weight=w)
        assert got == want
        if "published" in got:
            published += 1
            a, b = port.current(), ref.current()
            assert a["version"] == b["version"]
            for k in t:
                assert a["params"][k].dtype == {
                    "float32": torch.float32,
                    "bfloat16": torch.bfloat16}[dtype]
                assert _bits(a["params"][k]) == _bits(b["params"][k]), k
    assert published == 4
    assert port.snapshot_stats() == ref.snapshot_stats()
    assert port.snapshot_stats()["dropped_dead"] == 1


def test_buffered_contribution_survives_in_place_mutation():
    # A torch tensor is mutable (a jax array is not): the aggregator
    # clones every leaf when the offer lands, nested ones included, so a
    # driver stepping its params in place after offer() changes nothing
    # that is buffered.
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=3, staleness="constant"))
    params = {"w": torch.arange(12.0).reshape(3, 4),
              "layers": [{"b": torch.ones(5, dtype=torch.bfloat16)}]}
    before = [_bits(params["w"]), _bits(params["layers"][0]["b"])]
    agg.offer("alice", params, round_tag=0)
    with torch.no_grad():
        params["w"].mul_(-7.0)
        params["layers"][0]["b"].add_(3.0)
    buffered = agg.export_state()["buffer"][0]["tree"]
    assert [_bits(buffered["w"]),
            _bits(buffered["layers"][0]["b"])] == before
    assert buffered["w"].data_ptr() != params["w"].data_ptr()


# ---------------------------------------------------------------------------
# Driver surface validation (no runtime needed)
# ---------------------------------------------------------------------------


def test_async_round_rejects_callable_staleness():
    with pytest.raises(TypeError, match="cannot ride the wire"):
        async_round({"alice": object()}, staleness_fn=lambda s: 1.0)


def test_async_round_requires_publish_target_at_root():
    import types

    handle = types.SimpleNamespace(party="bob", name="m")
    with pytest.raises(ValueError, match="aggregating root"):
        async_round({"alice": object()}, publish_to=handle)


def test_fed_aggregate_mode_knob_validation():
    from rayfed_tpu_torch.federated import fed_aggregate

    objs = {"alice": object()}
    with pytest.raises(ValueError, match="sync-only"):
        fed_aggregate(objs, op="sum", mode="async")
    with pytest.raises(ValueError, match="sync-only"):
        fed_aggregate(objs, mode="async", topology="tree")
    with pytest.raises(ValueError, match="weights"):
        fed_aggregate(objs, mode="async", op="wmean")
    with pytest.raises(ValueError, match="mode must be"):
        fed_aggregate(objs, mode="eventually")
    for kw in (dict(buffer_k=2), dict(staleness_fn="poly"),
               dict(round_tag=3)):
        with pytest.raises(ValueError, match="async-only"):
            fed_aggregate(objs, **kw)


@pytest.mark.parametrize("call", ["async_round", "fed_aggregate",
                                  "masked_offer", "poke"])
def test_secure_async_raises_naming_item_11(call):
    from rayfed_tpu_torch import async_rounds
    from rayfed_tpu_torch.federated import fed_aggregate

    with pytest.raises(NotImplementedError, match="item 11"):
        if call == "async_round":
            async_round({"alice": object()}, secure=True)
        elif call == "fed_aggregate":
            fed_aggregate({"alice": object()}, mode="async", secure=True)
        elif call == "masked_offer":
            BufferedAggregator(AsyncAggregationConfig()).offer(
                "alice", {"__secagg__": True, "round": 0}, round_tag=0)
        else:
            async_rounds.poke_secure_sessions()


# ---------------------------------------------------------------------------
# fed.get single + on_missing="drop" -> fed.MISSING
# ---------------------------------------------------------------------------


def test_get_single_missing_resolves_to_missing_sentinel():
    fed.init(addresses=get_addresses(["alice"]), party="alice",
             job_name="asyncdrop",
             config={"cross_silo_comm": dict(FAST_COMM_CONFIG)})
    try:
        @fed.remote
        class Slow:
            def work(self, t):
                time.sleep(t)
                return 7

        s = Slow.party("alice").remote()
        pending = s.work.remote(1.5)
        t0 = time.monotonic()
        assert fed.get(pending, timeout=0.05, on_missing="drop") is fed.MISSING
        assert time.monotonic() - t0 < 1.0
        assert fed.get(pending, timeout=30.0, on_missing="drop") == 7
    finally:
        fed.shutdown()


# ---------------------------------------------------------------------------
# Spawned 2-party runs under a seeded straggler schedule
# ---------------------------------------------------------------------------

_DELAY_MS = 300
_ROUNDS = 4


def _straggler_config(seed):
    return {
        "cross_silo_comm": dict(FAST_COMM_CONFIG),
        "resilience": {"fault_schedule": {"seed": seed, "rules": [{
            "fault": "delay", "src": "bob", "prob": 1.0,
            "max_delay_ms": _DELAY_MS}]}},
    }


def _drain(fed_, handles):
    for h in handles:
        fed_.get(list(h.offers.values()))


def _run_chaos_party(party, addresses):
    import numpy as np_
    import torch as torch_

    import rayfed_tpu_torch as fed_
    from rayfed_tpu_torch.async_rounds import async_session_stats
    from rayfed_tpu_torch.federated import fed_aggregate

    fed_.init(addresses=addresses, party=party, config=_straggler_config(17),
              job_name="async-chaos")

    @fed_.remote
    def contrib(base, r):
        return {"g": torch_.full((256,), float(base + r))}

    bases = {"alice": 1.0, "bob": 2.0}

    def objs(r):
        return {p: contrib.party(p).remote(bases[p], r) for p in bases}

    fed_.get(fed_aggregate(objs(0), op="mean"))  # warm-up: dial
    t0 = time.monotonic()
    for r in range(_ROUNDS):
        val = fed_.get(fed_aggregate(objs(r), op="mean"))
        np_.testing.assert_allclose(val["g"].numpy(), 1.5 + r, rtol=1e-6)
    t_sync = time.monotonic() - t0
    handles = []
    t0 = time.monotonic()
    for r in range(_ROUNDS):
        handles.append(fed_.async_round(
            objs(r), round_tag=r, buffer_k=1, staleness_fn="constant",
            root="alice", session="chaos", fetch_model=False))
    deadline = time.monotonic() + 60
    while True:
        stats = fed_.get(async_session_stats("alice", "chaos"))
        if stats["publishes"] >= _ROUNDS:
            break
        assert time.monotonic() < deadline, stats
        time.sleep(0.02)
    t_async = time.monotonic() - t0
    _drain(fed_, handles)
    assert t_async < t_sync, (t_async, t_sync)
    assert t_sync > _ROUNDS * 0.02
    stats = fed_.get(async_session_stats("alice", "chaos"))
    assert stats["accepted"] == 2 * _ROUNDS
    assert stats["version"] == stats["publishes"] == 2 * _ROUNDS
    fed_.shutdown()


def test_torch_async_rounds_land_while_sync_stalls():
    run_parties(_run_chaos_party, ["alice", "bob"], timeout=150)


def _run_pipelined_party(party, addresses):
    import torch as torch_

    import rayfed_tpu_torch as fed_
    from rayfed_tpu_torch.async_rounds import async_session_stats

    fed_.init(addresses=addresses, party=party, config=_straggler_config(23),
              job_name="async-pipe")

    @fed_.remote
    def contrib(base, r):
        return {"g": torch_.full((256,), float(base + r))}

    bases = {"alice": 0.0, "bob": 1.0}

    def objs(r):
        return {p: contrib.party(p).remote(bases[p], r) for p in bases}

    def window(session, pipelined):
        handles = []
        t0 = time.monotonic()
        for r in range(_ROUNDS):
            h = fed_.async_round(objs(r), round_tag=r, buffer_k=2,
                                 staleness_fn="constant", root="alice",
                                 session=session, fetch_model=False)
            handles.append(h)
            if not pipelined:
                _drain(fed_, [h])
        deadline = time.monotonic() + 60
        while fed_.get(async_session_stats("alice", session))[
                "publishes"] < _ROUNDS:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        dt = time.monotonic() - t0
        _drain(fed_, handles)
        return dt

    _drain(fed_, [fed_.async_round(objs(0), round_tag=0, buffer_k=2,
                                   staleness_fn="constant", root="alice",
                                   session="warm", fetch_model=False)])
    t_serial = window("serial", pipelined=False)
    t_pipe = window("pipe", pipelined=True)
    assert t_pipe < t_serial, (t_pipe, t_serial)
    m = fed_.get(fed_.async_round(
        objs(_ROUNDS), round_tag=_ROUNDS, buffer_k=2,
        staleness_fn="constant", root="alice", session="pipe").model)
    assert m["version"] >= _ROUNDS
    leaves = m["params"]["g"]
    assert isinstance(leaves, torch_.Tensor)
    assert 0.0 <= float(leaves.min()) and float(leaves.max()) <= _ROUNDS + 1
    deadline = time.monotonic() + 60
    while fed_.get(async_session_stats("alice", "pipe"))["accepted"] < \
            2 * (_ROUNDS + 1):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    fed_.shutdown()


def test_torch_pipelined_rounds_overlap_without_corruption():
    run_parties(_run_pipelined_party, ["alice", "bob"], timeout=150)


# ---------------------------------------------------------------------------
# A mixed-package async round over localhost TCP
# ---------------------------------------------------------------------------

MIXED_PKG = {"alice": "torch", "bob": "jax"}
MIXED_WEIGHTS = {"alice": 0.37, "bob": 1000.5}


def _mixed_tree(party, session):
    rng = np.random.default_rng(
        {"alice": 1, "bob": 2}[party] + 10 * ("tj" == session))
    return {"w": rng.standard_normal((24, 5)).astype(np.float32),
            "layers": [{"b": (rng.standard_normal(9) * 100).astype(
                np.float32)}]}


def _run_mixed_party(party, addresses, out_dir):
    if MIXED_PKG[party] == "jax":
        import jax.numpy as jnp

        import rayfed_tpu as fed_
        from rayfed_tpu import async_rounds as ar

        def leaf(x):
            return jnp.asarray(x)
    else:
        import torch as torch_

        import rayfed_tpu_torch as fed_
        from rayfed_tpu_torch import async_rounds as ar

        def leaf(x):
            return torch_.from_numpy(x.copy())

    fed_.init(addresses=addresses, party=party,
              config={"cross_silo_comm": dict(FAST_COMM_CONFIG),
                      "aggregation": {"async_buffer_k": 2}})

    @fed_.remote
    def contrib(name, session):
        t = _mixed_tree(name, session)
        return {"w": leaf(t["w"]), "layers": [{"b": leaf(t["layers"][0]["b"])}]}

    out = {}
    # Session "tj" folds at alice (torch), "jt" at bob (jax); each root
    # receives the other package's contribution over the wire.
    for session, root in (("tj", "alice"), ("jt", "bob")):
        objs = {p: contrib.party(p).remote(p, session) for p in MIXED_PKG}
        statuses = []
        for tag in (0, 1):
            h = ar.async_round(objs, root=root, weights=MIXED_WEIGHTS,
                               round_tag=tag, session=session,
                               fetch_model=False)
            statuses.append(fed_.get([h.offers[p] for p in MIXED_PKG]))
        if party == root:
            cur = ar.get_session(session).current()
            out[session] = dict(
                statuses=statuses, version=cur["version"],
                bits=(_bits(cur["params"]["w"]),
                      _bits(cur["params"]["layers"][0]["b"])))
    fed_.shutdown()
    with open(f"{out_dir}/{party}.pkl", "wb") as f:
        pickle.dump(out, f)


def test_mixed_package_async_round_folds_bitwise(tmp_path):
    from rayfed_tpu import async_rounds as jasync
    from rayfed_tpu import config as jconfig

    run_parties(_run_mixed_party, list(MIXED_PKG), timeout=150,
                extra_args=(str(tmp_path),))
    got = {}
    for p in MIXED_PKG:
        with open(tmp_path / f"{p}.pkl", "rb") as f:
            got.update(pickle.load(f))
    for session, root in (("tj", "alice"), ("jt", "bob")):
        res = got[session]
        # Each round's two offers fold into one version, in the order
        # they arrived (the second one's status names the publish).
        assert res["version"] == 2
        order = []
        for tag, statuses in enumerate(res["statuses"]):
            assert all(st["accepted"] for st in statuses)
            first = [p for p, st in zip(MIXED_PKG, statuses)
                     if "published" not in st]
            order += [(tag, p) for p in first + [
                p for p in MIXED_PKG if p not in first]]
        # The OTHER package's aggregator, fed the same offers in the
        # same order, publishes the same bits.
        other_pkg = "torch" if MIXED_PKG[root] == "jax" else "jax"
        if other_pkg == "jax":
            import jax.numpy as jnp

            agg = jasync.BufferedAggregator(jconfig.AsyncAggregationConfig(
                buffer_k=2))

            def conv(t):
                return {"w": jnp.asarray(t["w"]), "layers": [
                    {"b": jnp.asarray(t["layers"][0]["b"])}]}
        else:
            agg = BufferedAggregator(AsyncAggregationConfig(buffer_k=2))

            def conv(t):
                return {"w": torch.from_numpy(t["w"]), "layers": [
                    {"b": torch.from_numpy(t["layers"][0]["b"])}]}
        for tag, p in order:
            agg.offer(p, conv(_mixed_tree(p, session)), round_tag=tag,
                      weight=MIXED_WEIGHTS[p])
        params = agg.current()["params"]
        assert agg.current()["version"] == 2
        assert res["bits"] == (_bits(params["w"]),
                               _bits(params["layers"][0]["b"])), session
