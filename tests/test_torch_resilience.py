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

"""The port's resilience plane on torch trees, mirroring
``test_resilience.py`` with the same assertions (docs/resilience.md).

Fast half: the fault injector, retry engine, liveness state machine, and
degraded-mode policy driven in-process with fakes — no transport, no
spawns. Slow half: a 2-party FedAvg chaos run under a seeded schedule
(partition + delay + drop) asserting the round completes, degrades to the
surviving contributors with correct re-weighting, and that two same-seed
runs produce byte-identical fault traces. The rounds' updates are torch
tensors and the fold is the port's ``elastic_weighted_mean``. Beyond the
mirror: a ``corrupt`` rule flips one bit of a torch leaf (the same bit as
of the numpy leaf with the same bytes), link pacing counts a torch leaf's
bytes, and a mixed job (a JAX alice, a torch bob) under the chaos
schedule records the all-torch job's fault trace byte for byte. This
module imports no jax; the mixed case loads the JAX package only in its
alice process.
"""

import json
import socket
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.resilience.degraded import (
    MISSING,
    is_missing_error,
    resolve_with_policy,
)
from rayfed_tpu_torch.resilience.inject import (
    FaultRule,
    FaultSchedule,
    InjectedFault,
    InjectingSenderProxy,
    _corrupt_value,
)
from rayfed_tpu_torch.resilience.liveness import (
    ALIVE,
    DEAD,
    SUSPECT,
    LivenessConfig,
    LivenessMonitor,
)
from rayfed_tpu_torch.resilience.retry import (
    Deadline,
    RetryPolicy,
    grpc_retry_policy,
    run_with_retry,
)
from tests.utils import get_addresses, run_parties

PING = "ping"  # _private.constants.PING_SEQ_ID


# ---------------------------------------------------------------------------
# Retry engine
# ---------------------------------------------------------------------------


def test_run_with_retry_exhausts_to_plain_connection_error():
    calls = []
    pol = RetryPolicy(max_attempts=3, initial_backoff_ms=1, max_backoff_ms=2,
                      jitter=False)

    def fn(attempt):
        calls.append(attempt)
        raise OSError("dial refused")

    with pytest.raises(ConnectionError) as ei:
        run_with_retry(fn, pol, describe="dial bob")
    assert calls == [1, 2, 3]
    # Exactly ConnectionError, not a subclass: the sending-failure-handler
    # contract (test_send_failure_when_peer_never_starts) matches on it.
    assert type(ei.value) is ConnectionError
    assert "dial bob failed after 3 attempt(s)" in str(ei.value)


def test_run_with_retry_returns_first_success():
    pol = RetryPolicy(max_attempts=5, initial_backoff_ms=1, jitter=False)

    def fn(attempt):
        if attempt < 3:
            raise OSError("not yet")
        return f"ok@{attempt}"

    assert run_with_retry(fn, pol) == "ok@3"


def test_run_with_retry_give_up_on_beats_retry_on():
    # socket.timeout is an OSError, but a send that already burned its
    # per-op budget must fail NOW, not re-dial (the old _send_half_duplex
    # behavior the engine had to preserve).
    calls = []
    pol = RetryPolicy(max_attempts=5, initial_backoff_ms=1, jitter=False)

    def fn(attempt):
        calls.append(attempt)
        raise socket.timeout("budget burned")

    with pytest.raises(socket.timeout):
        run_with_retry(fn, pol, retry_on=(OSError,),
                       give_up_on=(socket.timeout,))
    assert calls == [1]


def test_run_with_retry_deadline_bounds_the_loop():
    calls = []
    pol = RetryPolicy(max_attempts=1000, initial_backoff_ms=20,
                      max_backoff_ms=20, jitter=False)

    def fn(attempt):
        calls.append(attempt)
        raise OSError("never up")

    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        run_with_retry(fn, pol, deadline=Deadline(0.1))
    assert time.monotonic() - t0 < 5.0
    assert len(calls) < 1000


def test_backoff_sequence_and_camelcase_aliases():
    pol = RetryPolicy(initial_backoff_ms=100, max_backoff_ms=400,
                      backoff_multiplier=2.0)
    assert [pol.backoff_s(a) for a in (1, 2, 3, 4)] == [0.1, 0.2, 0.4, 0.4]
    # The reference's gRPC service-config spelling parses too.
    pol = RetryPolicy.from_dict(
        {"maxAttempts": 7, "initialBackoff": "1s", "maxBackoff": "2.5s"}
    )
    assert pol.max_attempts == 7
    assert pol.initial_backoff_ms == 1000
    assert pol.max_backoff_ms == 2500


def test_grpc_retry_policy_clamps_to_core_cap():
    # gRPC core hard-caps maxAttempts at 5 (and spams stderr when asked
    # for more); the rendered service config must pre-clamp.
    assert grpc_retry_policy(RetryPolicy(max_attempts=20))["maxAttempts"] == 5
    assert grpc_retry_policy(RetryPolicy(max_attempts=1))["maxAttempts"] == 2
    rendered = grpc_retry_policy(RetryPolicy(initial_backoff_ms=5000))
    assert rendered["initialBackoff"] == "5.0s"
    assert rendered["retryableStatusCodes"] == ["UNAVAILABLE"]


def test_config_retry_policy_is_the_engine_class():
    # config.RetryPolicy stayed importable as a re-export of the single
    # engine-owned dataclass — one policy type across all three transports.
    from rayfed_tpu_torch.config import RetryPolicy as ConfigRetryPolicy

    assert ConfigRetryPolicy is RetryPolicy


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


class _FakeSender:
    """Records sends; every send succeeds instantly."""

    def __init__(self):
        self.sent = []

    def send(self, dest_party, data, upstream_seq_id, downstream_seq_id,
             is_error=False):
        self.sent.append((dest_party, upstream_seq_id, downstream_seq_id))
        f = Future()
        f.set_result(True)
        return f

    def get_stats(self):
        return {}


def test_fault_rule_rejects_typos_and_bad_values():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultRule(fault="dorp")
    with pytest.raises(ValueError, match="prob"):
        FaultRule(fault="drop", prob=1.5)
    with pytest.raises(ValueError, match="porb"):
        FaultRule.from_dict({"fault": "drop", "porb": 0.5})
    # "for" is the schedule-dict spelling of the window length.
    rule = FaultRule.from_dict({"fault": "partition", "after": 2, "for": 3})
    assert rule.duration == 3


def test_injector_same_seed_same_trace():
    sched = {"seed": 7, "rules": [{"fault": "drop", "prob": 0.5}]}
    frames = [("bob", i, i) for i in range(64)]

    def run(seed):
        s = dict(sched, seed=seed)
        inj = InjectingSenderProxy(
            _FakeSender(), FaultSchedule.from_dict(s), "alice"
        )
        for dst, up, down in frames:
            inj.send(dst, b"x", up, down)
        return inj.fault_trace()

    t1, t2, t3 = run(7), run(7), run(8)
    assert t1, "a prob=0.5 rule over 64 frames injected nothing"
    assert len(t1) < len(frames), "prob=0.5 dropped every frame"
    assert t1 == t2  # bit-for-bit replay
    assert t1 != t3  # the seed actually keys the decisions


def test_injector_partition_window_counts_data_frames_only():
    sched = FaultSchedule.from_dict({
        "seed": 0,
        "rules": [{"fault": "partition", "src": "alice", "dst": "bob",
                   "after": 2, "for": 2}],
    })
    inner = _FakeSender()
    inj = InjectingSenderProxy(inner, sched, "alice")
    # Pings before the window pass and do not advance the data index.
    assert inj.send("bob", b"p", PING, PING).result() is True
    results = [inj.send("bob", b"x", i, i) for i in range(5)]
    for i in (0, 1, 4):  # outside [2, 4)
        assert results[i].result() is True
    for i in (2, 3):  # inside the window
        with pytest.raises(InjectedFault):
            results[i].result()
    # Other destinations never matched the rule.
    assert inj.send("carol", b"x", 9, 9).result() is True
    # The trace records data faults only, in send order.
    assert [(e["fault"], e["up"]) for e in inj.fault_trace()] == [
        ("partition", "2"), ("partition", "3"),
    ]


def test_injector_partition_takes_pings_down_with_the_data():
    sched = FaultSchedule.from_dict({
        "seed": 0,
        "rules": [{"fault": "partition", "src": "alice", "dst": "bob",
                   "after": 1}],
    })
    inj = InjectingSenderProxy(_FakeSender(), sched, "alice")
    assert inj.send("bob", b"p", PING, PING).result() is True  # idx 0: up
    assert inj.send("bob", b"x", 0, 0).result() is True
    # Data index is now 1 -> the cut is live; heartbeats fail like data.
    with pytest.raises(InjectedFault):
        inj.send("bob", b"p", PING, PING).result()
    with pytest.raises(InjectedFault):
        inj.send("bob", b"x", 1, 1).result()
    # Ping faults are counted in stats but kept out of the replay trace
    # (ping cadence is wall-clock-dependent; tracing it would diverge
    # same-seed runs).
    assert len(inj.fault_trace()) == 1
    assert inj.get_stats()["injected_faults"] == 2


def test_telemetry_pushes_follow_the_ping_rules():
    """The agent's pushes go out on its own clock: they never advance the
    data-send index (a partition window stays where the program's frames
    put it), probabilistic rules pass them, structural rules take them
    down with the data, and the replay trace never records them."""
    from rayfed_tpu_torch.proxy import rendezvous
    from rayfed_tpu_torch.telemetry.agent import PUSH_SEQ_PREFIX

    assert PUSH_SEQ_PREFIX.startswith(rendezvous.TELEMETRY_SEQ_PREFIX)
    sched = FaultSchedule.from_dict({
        "seed": 0,
        "rules": [
            {"fault": "partition", "dst": "bob", "after": 2},
            {"fault": "drop", "prob": 1.0, "after": 0, "for": 1},
        ],
    })
    inner = _FakeSender()
    inj = InjectingSenderProxy(inner, sched, "alice")
    tel = f"{PUSH_SEQ_PREFIX}alice"
    # Before any data frame: the drop rule's window [0, 1) does not take
    # the telemetry push, and the push does not use up data index 0.
    assert inj.send("bob", {"metrics": {}}, tel, "1").result() is True
    with pytest.raises(InjectedFault):  # data frame 0: dropped
        inj.send("bob", b"x", 0, 0).result()
    for i in range(2, 6):
        assert inj.send("bob", {"metrics": {}}, tel, str(i)).result() is True
    assert inj.send("bob", b"x", 1, 1).result() is True  # data frame 1
    # Data index 2 reached: the partition takes telemetry down too.
    with pytest.raises(InjectedFault):
        inj.send("bob", {"metrics": {}}, tel, "6").result()
    with pytest.raises(InjectedFault):
        inj.send("bob", b"x", 2, 2).result()
    assert [(e["fault"], e["up"]) for e in inj.fault_trace()] == [
        ("drop", "0"), ("partition", "2")]
    assert inj.get_stats()["injected_faults"] == 3


def test_injector_crash_is_permanent():
    sched = FaultSchedule.from_dict(
        {"seed": 0, "rules": [{"fault": "crash", "after": 1}]}
    )
    inj = InjectingSenderProxy(_FakeSender(), sched, "alice")
    assert inj.send("bob", b"x", 0, 0).result() is True
    for up in (1, 2, 3):
        with pytest.raises(InjectedFault):
            inj.send("bob", b"x", up, up).result()
    with pytest.raises(InjectedFault):  # crashed parties don't heartbeat
        inj.send("bob", b"p", PING, PING).result()


def test_injector_duplicate_and_delay_forward_the_frame():
    inner = _FakeSender()
    inj = InjectingSenderProxy(
        inner,
        FaultSchedule.from_dict(
            {"seed": 0, "rules": [{"fault": "duplicate", "prob": 1.0}]}
        ),
        "alice",
    )
    assert inj.send("bob", b"x", 0, 0).result() is True
    assert inner.sent == [("bob", 0, 0), ("bob", 0, 0)]

    inner = _FakeSender()
    inj = InjectingSenderProxy(
        inner,
        FaultSchedule.from_dict(
            {"seed": 0,
             "rules": [{"fault": "delay", "prob": 1.0, "max_delay_ms": 30}]}
        ),
        "alice",
    )
    fut = inj.send("bob", b"x", 0, 0)
    assert fut.result(timeout=5) is True  # forwarded after the pause
    assert inner.sent == [("bob", 0, 0)]


def test_corrupt_flips_exactly_one_bit_deterministically():
    x = {"w": torch.zeros((16,), dtype=torch.float32), "meta": "untouched"}
    c1 = _corrupt_value(x, 3, "alice", "bob", 1, 1)
    c2 = _corrupt_value(x, 3, "alice", "bob", 1, 1)
    assert c1["meta"] == "untouched"
    flipped = np.frombuffer(
        np.bitwise_xor(
            np.frombuffer(x["w"].numpy().tobytes(), dtype=np.uint8),
            np.frombuffer(c1["w"].numpy().tobytes(), dtype=np.uint8),
        ).tobytes(),
        dtype=np.uint8,
    )
    assert sum(int(b).bit_count() for b in flipped) == 1
    np.testing.assert_array_equal(
        np.asarray(c1["w"]), np.asarray(c2["w"])
    )  # same key -> same bit
    c3 = _corrupt_value(x, 4, "alice", "bob", 1, 1)
    assert c3["w"].numpy().tobytes() != c1["w"].numpy().tobytes()


def _tensor_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "float16"])
def test_corrupt_flips_the_numpy_leafs_bit_in_a_torch_leaf(dtype):
    """A torch leaf and a numpy leaf with the same bytes, at the same
    path of the same frame, get the same one bit flipped (the JAX
    package passes a non-numpy leaf through untouched)."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 5, 7)).astype(np.float32)
    if dtype == "int32":
        a = rng.integers(-1000, 1000, (3, 5, 7)).astype(np.int32)
    elif dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    elif dtype == "float16":
        a = a.astype(np.float16)
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(a.copy())
    assert _tensor_bytes(t) == a.tobytes()
    tree_np = {"layers": [{"w": a}], "n": 3}
    tree_t = {"layers": [{"w": t}], "n": 3}
    c_np = _corrupt_value(tree_np, 9, "alice", "bob", "7", "8")
    c_t = _corrupt_value(tree_t, 9, "alice", "bob", "7", "8")
    got = c_t["layers"][0]["w"]
    assert isinstance(got, torch.Tensor)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert got.device == t.device
    assert _tensor_bytes(got) == c_np["layers"][0]["w"].tobytes()
    diff = np.bitwise_xor(
        np.frombuffer(_tensor_bytes(got), np.uint8),
        np.frombuffer(_tensor_bytes(t), np.uint8),
    )
    assert sum(int(b).bit_count() for b in diff) == 1
    assert _tensor_bytes(t) == a.tobytes()  # the sent tensor is untouched
    assert c_t["n"] == 3


def test_corrupt_rule_flips_a_torch_leaf_through_the_injector():
    got = []

    class _Capturing(_FakeSender):
        def send(self, dest_party, data, up, down, is_error=False):
            got.append(data)
            return super().send(dest_party, data, up, down, is_error)

    inner = _Capturing()
    inj = InjectingSenderProxy(
        inner,
        FaultSchedule.from_dict({"seed": 5, "rules": [
            {"fault": "corrupt", "prob": 1.0, "after": 1, "for": 1}]}),
        "alice",
    )
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for i in range(3):
        assert inj.send("bob", {"w": w}, i, i).result() is True
    assert [torch.equal(d["w"], w) for d in got] == [True, False, True]
    diff = np.bitwise_xor(
        np.frombuffer(_tensor_bytes(got[1]["w"]), np.uint8),
        np.frombuffer(_tensor_bytes(w), np.uint8),
    )
    assert sum(int(b).bit_count() for b in diff) == 1
    assert [(e["fault"], e["up"]) for e in inj.fault_trace()] == [
        ("corrupt", "1")]


def test_link_pacing_counts_a_torch_leafs_bytes():
    # 1 Mbit/s: a 12,500-byte tensor occupies the pipe for ~100ms, as the
    # same bytes in an ndarray do (the JAX package counts 64 B for a leaf
    # that is not an ndarray).
    inj = InjectingSenderProxy(
        _FakeSender(),
        FaultSchedule.from_dict({"seed": 0, "links": [{"rate_mbit": 1}]}),
        "alice",
    )
    w = torch.zeros(3125, dtype=torch.float32)
    t0 = time.monotonic()
    assert inj.send("bob", {"w": w}, 1, 1).result(timeout=5) is True
    assert time.monotonic() - t0 >= 0.09
    assert inj.link_stats()["paced_bytes"] == 12500


# ---------------------------------------------------------------------------
# Liveness
# ---------------------------------------------------------------------------


def test_liveness_config_validates_thresholds():
    with pytest.raises(ValueError):
        LivenessConfig(suspect_after=0)
    with pytest.raises(ValueError):
        LivenessConfig(suspect_after=5, dead_after=2)


def test_liveness_state_machine_and_resurrection():
    mode = {"ok": True}

    def probe(p):
        f = Future()
        if mode["ok"]:
            f.set_result(True)
        else:
            f.set_exception(ConnectionError("cut"))
        return f

    mon = LivenessMonitor(
        ["bob"],
        LivenessConfig(interval_ms=10, suspect_after=2, dead_after=4),
        probe_fn=probe,
    )
    mon.tick()  # issue
    mon.tick()  # ack -> ALIVE
    assert mon.state("bob") == ALIVE
    mode["ok"] = False
    mon.tick()  # settles the last good probe, reissues a failing one
    mon.tick()  # miss 1
    assert mon.state("bob") == ALIVE
    mon.tick()  # miss 2 -> SUSPECT
    assert mon.state("bob") == SUSPECT
    mon.tick()  # miss 3
    mon.tick()  # miss 4 -> DEAD
    assert mon.state("bob") == DEAD
    assert mon.view() == {"bob": DEAD}
    # A DEAD verdict is a local view, not a tombstone: one ack resurrects.
    mode["ok"] = True
    mon.tick()  # settles the failing probe (miss 5), reissues a good one
    mon.tick()  # ack -> ALIVE
    assert mon.state("bob") == ALIVE


def test_liveness_stuck_probe_misses_without_piling_up():
    issued = []

    def probe(p):
        issued.append(p)
        return Future()  # never resolves

    mon = LivenessMonitor(
        ["bob"],
        LivenessConfig(interval_ms=10, suspect_after=1, dead_after=2,
                       timeout_ms=1),
        probe_fn=probe,
    )
    mon.tick()
    time.sleep(0.02)
    mon.tick()  # past timeout -> miss, probe stays out
    mon.tick()  # still out -> another miss
    assert mon.state("bob") == DEAD
    assert issued == ["bob"], "one probe in flight per peer, ever"


def test_module_level_views_without_monitor():
    from rayfed_tpu_torch.resilience import liveness

    assert liveness.get_monitor() is None
    assert fed.liveness_view() == {}
    assert fed.party_state("anyone") == ALIVE


# ---------------------------------------------------------------------------
# Degraded-mode policy
# ---------------------------------------------------------------------------


def _done(v):
    f = Future()
    f.set_result(v)
    return f


def _failed(e):
    f = Future()
    f.set_exception(e)
    return f


def test_missing_sentinel_identity_and_pickling():
    import pickle

    assert not MISSING
    assert repr(MISSING) == "fed.MISSING"
    assert fed.MISSING is MISSING
    assert pickle.loads(pickle.dumps(MISSING)) is MISSING


def test_is_missing_error_classification():
    import concurrent.futures

    assert is_missing_error(TimeoutError("recv deadline"))
    assert is_missing_error(concurrent.futures.TimeoutError())
    assert is_missing_error(ConnectionError("retries exhausted"))
    assert is_missing_error(InjectedFault("injected drop"))
    assert not is_missing_error(ValueError("application bug"))
    # An error envelope proves the peer was ALIVE and its task failed —
    # never degradable, no matter the policy.
    assert not is_missing_error(fed.FedRemoteError("bob", ValueError("x")))


def test_resolve_with_policy_substitutes_and_indexes():
    futures = [_done(1), _failed(TimeoutError("gone")), _done(3)]
    values, missing = resolve_with_policy(futures, 1.0, "default", MISSING)
    assert values == [1, MISSING, 3]
    assert missing == [1]
    # "raise" propagates the first missing failure.
    with pytest.raises(TimeoutError):
        resolve_with_policy(
            [_done(1), _failed(TimeoutError("gone"))], 1.0, "raise"
        )
    # Non-missing errors propagate even under "default".
    with pytest.raises(ValueError):
        resolve_with_policy([_failed(ValueError("bug"))], 1.0, "default")
    with pytest.raises(fed.FedRemoteError):
        resolve_with_policy(
            [_failed(fed.FedRemoteError("bob", ValueError("x")))],
            1.0, "default",
        )


def test_resolve_with_policy_shares_one_timeout_budget():
    # Three never-resolving futures under one 0.2s budget: the call costs
    # ~one timeout, not three.
    t0 = time.monotonic()
    values, missing = resolve_with_policy(
        [Future(), Future(), Future()], 0.2, "default"
    )
    assert time.monotonic() - t0 < 5.0
    assert values == [MISSING] * 3
    assert missing == [0, 1, 2]


def test_get_validates_on_missing_before_touching_the_runtime():
    with pytest.raises(ValueError, match="on_missing"):
        fed.get([], on_missing="bogus")
    # A single FedObject with on_missing="drop" is legal since the
    # async-rounds PR: it resolves to fed.MISSING when absent (runtime
    # path covered in tests/test_async_rounds.py).


def test_elastic_weighted_mean_drops_missing_and_dead():
    from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean

    contribs = {
        "alice": {"w": torch.full((4,), 1.0, dtype=torch.float32)},
        "bob": {"w": torch.full((4,), 3.0, dtype=torch.float32)},
        "carol": MISSING,
    }
    weights = {"alice": 1.0, "bob": 3.0, "carol": 2.0}
    # carol missing -> (1*1 + 3*3) / 4 = 2.5
    agg = elastic_weighted_mean(contribs, weights=weights)
    np.testing.assert_allclose(np.asarray(agg["w"]), 2.5)
    # bob's value DID arrive, but the liveness verdict wins: a
    # partitioned peer's stale update is worse than no update.
    agg = elastic_weighted_mean(
        contribs, weights=weights, liveness={"bob": DEAD, "carol": SUSPECT}
    )
    np.testing.assert_allclose(np.asarray(agg["w"]), 1.0)
    with pytest.raises(ValueError, match="no surviving contributors"):
        elastic_weighted_mean(
            {"alice": None, "bob": MISSING}, liveness={}
        )


# ---------------------------------------------------------------------------
# Chaos: 2-party FedAvg under a seeded fault schedule (slow)
# ---------------------------------------------------------------------------

CHAOS_PARTIES = ("alice", "bob")
CHAOS_ROUNDS = 6
CHAOS_PARTITION_AFTER = 3  # alice->bob cut after 3 data frames (rounds 0-2)
CHAOS_WEIGHTS = {"alice": 1.0, "bob": 3.0}
CHAOS_BASES = {"alice": 1.0, "bob": 3.0}


def _chaos_schedule(seed):
    return {
        "seed": seed,
        "rules": [
            # One-way blackhole alice->bob from the 4th data frame on;
            # pings ride the same link, so alice's heartbeats to bob die
            # with the data (bob's view of alice is via bob's OWN probes,
            # which still succeed -> asymmetric verdicts, as in a real
            # one-way cut).
            {"fault": "partition", "src": "alice", "dst": "bob",
             "after": CHAOS_PARTITION_AFTER},
            {"fault": "delay", "src": "alice", "prob": 0.4,
             "max_delay_ms": 40},
            {"fault": "drop", "src": "alice", "dst": "bob", "prob": 0.2},
        ],
    }


@fed.remote
def _chaos_update(base, r):
    return {"w": torch.full((4,), base * (r + 1), dtype=torch.float32)}


def _chaos_update_numpy(base, r):
    return {"w": np.full((4,), base * (r + 1), dtype=np.float32)}


def run_chaos_party(party, addresses, seed, trace_path, pkgs=None):
    """One party of the chaos job; ``pkgs`` maps a party to "jax" for a
    party on the JAX package (its update an ndarray tree, its fold the
    JAX package's), the port otherwise."""
    global fed, _chaos_update
    if (pkgs or {}).get(party) == "jax":
        import rayfed_tpu as fed

        _chaos_update = fed.remote(_chaos_update_numpy)
    fed.init(
        addresses=addresses,
        party=party,
        config={
            "barrier_on_initializing": True,
            "cross_silo_comm": {
                "retry_policy": {
                    "max_attempts": 2,
                    "initial_backoff_ms": 50,
                    "max_backoff_ms": 100,
                },
                "timeout_in_ms": 2000,
                "recv_timeout_in_ms": 2000,
                "send_deadline_in_ms": 4000,
            },
            "resilience": {
                "fault_schedule": _chaos_schedule(seed),
                "liveness": {
                    "interval_ms": 100,
                    "suspect_after": 2,
                    "dead_after": 4,
                    "timeout_ms": 300,
                },
            },
        },
    )
    for r in range(CHAOS_ROUNDS):
        if party == "alice" and r == CHAOS_ROUNDS - 1:
            # The cut has been live since round CHAOS_PARTITION_AFTER;
            # give the monitor a beat to reach its verdict before the
            # final round asserts on it.
            t_end = time.monotonic() + 20
            while fed.party_state("bob") != DEAD and time.monotonic() < t_end:
                time.sleep(0.05)
            assert fed.party_state("bob") == DEAD, fed.liveness_view()
        a = _chaos_update.party("alice").remote(CHAOS_BASES["alice"], r)
        b = _chaos_update.party("bob").remote(CHAOS_BASES["bob"], r)
        got = fed.get([a, b], timeout=3.0, on_missing="default")
        contribs = dict(zip(CHAOS_PARTIES, got))
        view = fed.liveness_view()
        if fed.__name__ == "rayfed_tpu":
            from rayfed_tpu.ops.aggregate import elastic_weighted_mean
        else:
            from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean

        agg = elastic_weighted_mean(
            contribs, weights=CHAOS_WEIGHTS, liveness=view
        )
        # Independent recomputation of the surviving weighted mean: the
        # aggregate must equal the re-normalized average of exactly what
        # survived this round on THIS party.
        survivors = [
            p for p in CHAOS_PARTIES
            if contribs[p] is not fed.MISSING and view.get(p) != DEAD
        ]
        assert party in survivors  # own value is local; self is never DEAD
        num = sum(CHAOS_WEIGHTS[p] * CHAOS_BASES[p] * (r + 1)
                  for p in survivors)
        den = sum(CHAOS_WEIGHTS[p] for p in survivors)
        np.testing.assert_allclose(
            np.asarray(agg["w"]), np.full((4,), num / den, np.float32),
            rtol=1e-6,
        )
        # Same surviving set, same bits, regardless of reduction shape:
        # tree and ring lay their schedule out over the survivors (a
        # DEAD party never appears in the plan at all), and the
        # integer-valued float32 updates make every partial sum exact,
        # so the planned folds must reproduce the flat aggregate byte
        # for byte even while parties are dropping.
        for shape in ("tree", "ring"):
            shaped = elastic_weighted_mean(
                contribs, weights=CHAOS_WEIGHTS, liveness=view,
                topology=shape,
            )
            assert np.asarray(shaped["w"]).tobytes() == \
                np.asarray(agg["w"]).tobytes(), shape
        if r == CHAOS_ROUNDS - 1:
            if party == "alice":
                assert "bob" not in survivors, (survivors, view)
            else:
                # Bob never hears from alice again after the cut; his
                # probes to alice still succeed (one-way), so the drop is
                # driven by absence, not by a DEAD verdict.
                assert contribs["alice"] is fed.MISSING
                assert survivors == ["bob"]
        time.sleep(0.4)  # local "training" keeps the heartbeat clock honest
    if party == "alice":
        with open(trace_path, "w") as f:
            json.dump(fed.fault_trace(), f, sort_keys=True)
    fed.shutdown()


def test_chaos_fedavg_two_party_deterministic(tmp_path):
    """The acceptance run: a 2-party FedAvg round sequence
    under a seeded drop+delay+partition schedule completes without
    hanging, degrades to the correctly re-weighted surviving aggregate
    once the partitioned peer is DEAD — and two runs with the same seed
    produce byte-identical fault traces."""
    seed = 20260806
    traces = []
    for run in range(2):
        trace_path = tmp_path / f"fault-trace-{run}.json"
        run_parties(
            run_chaos_party,
            list(CHAOS_PARTIES),
            timeout=150,
            extra_args=(seed, str(trace_path)),
            addresses=get_addresses(list(CHAOS_PARTIES)),
        )
        traces.append(trace_path.read_bytes())
    parsed = json.loads(traces[0])
    # The partition rule (index 0) must have fired on the post-cut frames.
    assert any(e["fault"] == "partition" for e in parsed), parsed
    assert traces[0] == traces[1], "same seed must replay bit-for-bit"


@pytest.mark.parametrize("jax_party", ["alice", "bob"])
def test_chaos_fault_trace_of_a_mixed_job_equals_the_torch_jobs(
        tmp_path, jax_party):
    """The chaos job with one party on the JAX package: every round's
    checks hold in both packages' parties, and alice's fault trace (the
    JAX package's injector when alice is the JAX party) is byte-equal
    to the all-torch job's under the same seed."""
    import threading

    seed = 20260806
    paths = [tmp_path / f"fault-trace-{i}.json" for i in range(2)]
    errors = []

    def job(path, pkgs):
        try:
            run_parties(
                run_chaos_party,
                list(CHAOS_PARTIES),
                timeout=150,
                extra_args=(seed, str(path), pkgs),
                addresses=get_addresses(list(CHAOS_PARTIES)),
            )
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    # The two jobs run side by side: the trace is a pure function of the
    # seed and the seq ids, never of timing.
    threads = [
        threading.Thread(target=job, args=(path, pkgs))
        for path, pkgs in zip(paths, ({}, {jax_party: "jax"}))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    traces = [path.read_bytes() for path in paths]
    assert any(e["fault"] == "partition" for e in json.loads(traces[0]))
    assert traces[1] == traces[0]


def test_topology_replan_when_party_dies_mid_round():
    """A party that goes DEAD after the reduction schedule was laid out
    but before the round ran: the driver re-plans over the survivors
    (the dead party never appears as a reduce destination — no subtree
    wedges on it) and the re-run round produces the survivors' mean."""
    from rayfed_tpu_torch import topology as topo
    from rayfed_tpu_torch.ops.aggregate import reduce_by_plan

    parties = [f"p{i}" for i in range(6)]
    contribs = {
        p: {"w": torch.full((8,), float(i + 1), dtype=torch.float32)}
        for i, p in enumerate(parties)
    }
    expect = np.mean([i + 1 for i in range(6) if i != 3])
    for shape in ("tree", "ring", "hier"):
        old = topo.plan(parties, shape)
        assert any(
            "p3" in (step.dst, *step.srcs)
            for lvl in old.levels for step in lvl
        )
        new = topo.replan(old, dead={"p3"})
        new.validate()
        assert "p3" not in new.parties
        assert new.root == old.root  # surviving root keeps ownership
        out = reduce_by_plan(new, {p: contribs[p] for p in new.parties})
        np.testing.assert_allclose(np.asarray(out["w"]), expect)
