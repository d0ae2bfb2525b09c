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

"""The port's federated engine on the CPU: one spawned process per party
over localhost TCP, with torch tensors, mirroring
``test_two_party_basic.py``, ``test_api.py``, ``test_transports.py``
(tcp), ``test_small_message.py``, ``test_reactor.py`` and
``test_donation_race.py``; plus error propagation and the refusal of
every config block whose plane is not ported. This module imports no
jax: the party processes load only ``rayfed_tpu_torch``.
"""

import socket
import time
from concurrent.futures import Future

import pytest
import torch

import rayfed_tpu_torch as fed
from tests.utils import FAST_COMM_CONFIG, get_addresses, run_parties

CONFIG = {"cross_silo_comm": dict(FAST_COMM_CONFIG)}
TIMEOUT = 60  # seconds per spawned party


@fed.remote
def produce(values):
    return torch.tensor(values, dtype=torch.float32)


@fed.remote
def aggregate(a, b):
    return a + b


@fed.remote
def identity(x):
    return x


def _parties(target, parties=("alice", "bob"), extra_args=()):
    run_parties(target, list(parties), timeout=TIMEOUT, extra_args=extra_args)


# ---------------------------------------------------------------------------
# Mirrors of test_two_party_basic.py
# ---------------------------------------------------------------------------


def run_basic_pass(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)
    a = produce.party("alice").remote([1.0, 2.0, 3.0])
    b = produce.party("bob").remote([2.0, 4.0, 6.0])
    result = fed.get(aggregate.party("alice").remote(a, b))
    assert torch.equal(result, torch.tensor([3.0, 6.0, 9.0]))
    fed.shutdown()


def run_containers(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)

    @fed.remote
    def consume(payload):
        a = payload["pair"][0]
        b = payload["pair"][1]["deep"]
        return float(a.sum() + b.sum())

    x = produce.party("alice").remote([1.0, 1.0])
    y = produce.party("bob").remote([2.0, 2.0])
    out = consume.party("bob").remote({"pair": (x, {"deep": y})})
    assert fed.get(out) == 6.0
    fed.shutdown()


def run_num_returns(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)

    @fed.remote
    def split():
        return torch.tensor([1.0]), torch.tensor([2.0], dtype=torch.bfloat16)

    lo, hi = split.party("alice").options(num_returns=2).remote()
    s = aggregate.party("bob").remote(lo, hi)
    assert torch.equal(fed.get(s), torch.tensor([3.0]))
    fed.shutdown()


def run_send_dedup(party, addresses):
    from rayfed_tpu_torch.proxy import barriers

    fed.init(addresses=addresses, party=party, config=CONFIG)
    x = produce.party("alice").remote([5.0])
    # The same alice-owned object consumed by two bob tasks: ONE push.
    r1 = identity.party("bob").remote(x)
    r2 = identity.party("bob").remote(x)
    assert torch.equal(fed.get(r1), torch.tensor([5.0]))
    assert torch.equal(fed.get(r2), torch.tensor([5.0]))
    if party == "alice":
        assert barriers.sender_proxy().get_stats()["send_op_count"] == 1
    if party == "bob":
        assert barriers.receiver_proxy().get_stats()["receive_op_count"] == 1
    fed.shutdown()


def run_bidirectional(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)
    ping_pong = produce.party("alice").remote([1.0])
    for _ in range(3):
        ping_pong = identity.party("bob").remote(ping_pong)
        ping_pong = identity.party("alice").remote(ping_pong)
    assert torch.equal(fed.get(ping_pong), torch.tensor([1.0]))
    fed.shutdown()


@pytest.mark.parametrize(
    "target",
    [run_basic_pass, run_containers, run_num_returns, run_send_dedup,
     run_bidirectional],
    ids=lambda f: f.__name__[4:],
)
def test_two_party_basic(target):
    _parties(target)


# ---------------------------------------------------------------------------
# Mirrors of test_api.py (single party)
# ---------------------------------------------------------------------------


def run_init_asserts(party, addresses):
    with pytest.raises(AssertionError):
        fed.init(addresses=None, party="alice")
    with pytest.raises(AssertionError):
        fed.init(addresses=addresses, party=None)
    with pytest.raises(AssertionError):
        fed.init(addresses=addresses, party="nonexistent")
    with pytest.raises(ValueError):
        fed.init(addresses={"alice": "bad_address"}, party="alice")

    fed.init(addresses=addresses, party=party)
    import rayfed_tpu_torch.config as fed_config
    from rayfed_tpu_torch._private.global_context import get_global_context

    cfg = fed_config.get_cluster_config(get_global_context().get_job_name())
    assert cfg.cluster_addresses == addresses
    assert cfg.current_party == party
    fed.shutdown()


def run_repeat_init(party, addresses):
    from rayfed_tpu_torch._private.global_context import get_global_context

    observed_ids = []
    for _ in range(3):
        fed.init(addresses=addresses, party=party)

        @fed.remote
        def f(x):
            return x + 1

        obj = f.party(party).remote(torch.tensor(1))
        observed_ids.append(obj.get_fed_task_id())
        assert fed.get(obj) == 2
        assert get_global_context() is not None
        fed.shutdown()
        assert get_global_context() is None
    # Deterministic seq ids restart identically after shutdown.
    assert len(set(observed_ids)) == 1


def run_kv_lifecycle(party, addresses):
    from rayfed_tpu_torch._private import kv

    fed.init(addresses=addresses, party=party, job_name="kvjob")
    assert kv.kv_initialized()
    assert kv.wrap_kv_key("kvjob", "k") == "FEDTPU#kvjob#k"
    kv.kv_put("kvjob", "k", b"v")
    assert kv.kv_get("kvjob", "k") == b"v"
    fed.shutdown()
    assert not kv.kv_initialized()
    assert kv.kv_get("kvjob", "k") is None


def run_local_pipeline(party, addresses):
    fed.init(addresses=addresses, party=party)

    @fed.remote
    def make(x):
        return torch.full((4,), x)

    a = make.party(party).remote(1.0)
    b = make.party(party).remote(2.0)
    c = aggregate.party(party).remote(a, b)
    assert torch.equal(fed.get(c), torch.full((4,), 3.0))

    @fed.remote
    def pair():
        return 1, 2

    x, y = pair.party(party).options(num_returns=2).remote()
    assert fed.get(x) == 1 and fed.get(y) == 2
    fed.shutdown()


def run_occupied_port(party, addresses):
    blocker = socket.socket()
    host, port = addresses[party].split(":")
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind((host, int(port)))
    blocker.listen(1)
    try:
        with pytest.raises(AssertionError, match="[Aa]ddress|in use|bind"):
            fed.init(addresses=addresses, party=party)
    finally:
        blocker.close()


def run_shutdown_drains_under_its_context(party, addresses):
    from rayfed_tpu_torch._private import global_context

    fed.init(addresses=addresses, party=party)
    ctx = global_context.get_global_context()
    manager = ctx.get_cleanup_manager()
    stop = manager.stop
    seen = []

    def spy(**kwargs):
        seen.append(global_context.get_global_context())
        stop(**kwargs)

    manager.stop = spy
    fed.shutdown()
    # The drain tracks every error envelope it substitutes on this
    # context: the context must still be live while the drain runs.
    assert seen == [ctx]
    assert global_context.get_global_context() is None


@pytest.mark.parametrize(
    "target",
    [run_init_asserts, run_repeat_init, run_kv_lifecycle, run_local_pipeline,
     run_occupied_port, run_shutdown_drains_under_its_context],
    ids=lambda f: f.__name__[4:],
)
def test_single_party(target):
    _parties(target, ["alice"])


# ---------------------------------------------------------------------------
# Mirrors of test_transports.py (tcp), test_small_message.py and
# test_wire_precision.py's two-party push
# ---------------------------------------------------------------------------


def run_big_payload(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)

    @fed.remote
    def big():
        return torch.ones((1024, 1024))  # 4 MB

    @fed.remote
    def total(x):
        return float(x.sum())

    out = total.party("bob").remote(big.party("alice").remote())
    assert fed.get(out) == 1024 * 1024
    fed.shutdown()


def run_small_messages(party, addresses, threshold):
    comm = dict(FAST_COMM_CONFIG, small_message_threshold=threshold)
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": comm})
    values = [7, "s", None, {"k": [1, 2.5]}, b"\x00\x01",
              {"t": torch.arange(3, dtype=torch.int16)}]
    outs = [identity.party("bob").remote(v) for v in values]
    got = fed.get(outs)
    assert got[:5] == values[:5]
    assert torch.equal(got[5]["t"], values[5]["t"])
    fed.shutdown()


def run_bf16_push(party, addresses):
    comm = dict(FAST_COMM_CONFIG, payload_wire_dtype="bf16")
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": comm, "transport": "tcp"})

    def grads(seed):
        return torch.randn(2048, generator=torch.Generator().manual_seed(seed))

    @fed.remote
    def make(seed):
        return grads(seed)

    @fed.remote
    def check(g):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, grads(7), rtol=2**-8, atol=0)
        return float(g.abs().sum())

    got = fed.get(check.party("bob").remote(make.party("alice").remote(7)))
    assert got > 0
    fed.shutdown()


@pytest.mark.parametrize(
    "target, extra",
    [(run_big_payload, ()), (run_small_messages, (65536,)),
     (run_small_messages, (0,)), (run_bf16_push, ())],
    ids=["big_payload", "small_fast", "small_disabled", "bf16_push"],
)
def test_tcp_transport(target, extra):
    _parties(target, extra_args=extra)


# ---------------------------------------------------------------------------
# Error propagation and the capture at resolution
# ---------------------------------------------------------------------------


def run_error_propagation(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)

    @fed.remote
    def boom():
        raise ValueError("boom")

    x = boom.party("alice").remote()
    y = identity.party("bob").remote(x)
    if party == "alice":
        # The executing party re-raises its own error ...
        with pytest.raises(ValueError, match="boom"):
            fed.get(x)
    else:
        # ... every other party gets the envelope, and does not hang.
        with pytest.raises(fed.FedRemoteError):
            fed.get(x)
    # A task fed the failed value fails in its party, and its consumers
    # elsewhere get an envelope.
    # Bob queues y's envelope for alice and goes straight to shutdown:
    # its drain must deliver the envelope before the proxies stop.
    with pytest.raises(fed.FedRemoteError):
        fed.get(y)
    fed.shutdown()


STEPS = 4
N = 4096


@fed.remote
class InPlaceTrainer:
    """Each step updates the params IN PLACE and returns them: without
    the capture at resolution, a push still in flight would carry a later
    step's values (the torch counterpart of test_donation_race.py)."""

    def __init__(self):
        self.params = torch.zeros(N)

    def train(self):
        self.params.add_(1.0)
        return self.params


@fed.remote
def check_step(step, params):
    assert torch.equal(params, torch.full((N,), float(step))), params[:4]
    return float(params[0])


def run_in_place_race(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)
    trainer = InPlaceTrainer.party("alice").remote()
    outs = []
    for step in range(1, STEPS + 1):
        params = trainer.train.remote()
        # No fed.get between steps: the next add_ races every push.
        outs.append(check_step.party("bob").remote(step, params))
    assert fed.get(outs) == [float(s) for s in range(1, STEPS + 1)]
    fed.shutdown()


def run_late_push_of_a_mutated_value(party, addresses):
    from rayfed_tpu_torch._private import global_context

    fed.init(addresses=addresses, party=party, config=CONFIG)
    trainer = InPlaceTrainer.party("alice").remote()
    p1 = trainer.train.remote()
    p2 = trainer.train.remote()
    if party == "alice":
        # Both steps have run before p1's push is registered: p1's
        # buffers now hold step 2, which must not be sent as step 1.
        p2.get_value_future().result()
    out = check_step.party("bob").remote(1, p1)
    with pytest.raises(fed.FedRemoteError):
        fed.get(out)
    if party == "alice":
        err = global_context.get_global_context().get_cleanup_manager(
        ).get_last_sending_error()
        assert "mutated in place" in str(err), err
    fed.shutdown()


@pytest.mark.parametrize(
    "target",
    [run_error_propagation, run_in_place_race,
     run_late_push_of_a_mutated_value],
    ids=["error_propagation", "in_place_race", "late_push_of_mutated"])
def test_two_party_semantics(target):
    _parties(target)


def test_wait_for_inflight_returns_once_every_tracked_send_resolved():
    import threading

    from rayfed_tpu_torch._private.cleanup import CleanupManager

    manager = CleanupManager("alice", lambda: False)
    acked, late = Future(), Future()
    manager.push_to_sending(acked, "bob", 1, 2)
    manager.push_to_sending(late, "bob", 3, 4)
    acked.set_result(True)
    assert manager.wait_for_inflight(timeout=0.05) is False
    threading.Timer(0.1, late.set_result, (True,)).start()
    assert manager.wait_for_inflight(timeout=10) is True
    assert late.done()
    assert manager.wait_for_inflight(timeout=0) is True


def test_host_snapshot_copies_every_tensor_leaf():
    from rayfed_tpu_torch.proxy import barriers

    p = torch.ones(3)
    value = {"p": p, "n": 7, "l": [torch.zeros(2, dtype=torch.bfloat16)]}
    snap = barriers._host_snapshot(value)
    p.add_(1.0)
    value["l"][0].add_(1.0)
    assert snap["n"] == 7
    assert torch.equal(snap["p"], torch.ones(3))
    assert torch.equal(snap["l"][0], torch.zeros(2, dtype=torch.bfloat16))
    assert barriers._host_snapshot("no tensors") == "no tensors"


def test_late_capture_refuses_a_value_mutated_since_it_resolved():
    from rayfed_tpu_torch._private import executor
    from rayfed_tpu_torch.proxy import barriers

    value = {"p": torch.zeros(3), "l": [torch.ones(2)], "n": 1}
    resolved = Future()
    executor.set_result_versioned(resolved, value)
    # Registered after resolution, nothing changed since: captured.
    snap = barriers._capture_for_send("bob", resolved).result()
    assert torch.equal(snap["p"], torch.zeros(3)) and snap["n"] == 1
    value["l"][0].add_(1.0)
    with pytest.raises(RuntimeError, match="mutated in place"):
        barriers._capture_for_send("bob", resolved).result()
    # Registered before resolution: captured as the value resolves.
    pending = Future()
    staged = barriers._capture_for_send("bob", pending)
    executor.set_result_versioned(pending, value)
    value["p"].add_(1.0)
    assert torch.equal(staged.result()["p"], torch.zeros(3))


def test_executor_shutdown_joins_its_lanes_and_frees_their_tasks():
    # An actor lane is a daemon thread. A task's tensors that the lane
    # frees while the interpreter finalizes make the process abort inside
    # torch's deallocator ("terminate called without an active
    # exception"), so shutdown joins each lane, and a lane frees a task's
    # arguments as soon as the task has run.
    import gc
    import weakref

    from rayfed_tpu_torch._private.executor import LocalExecutor

    ex = LocalExecutor(max_workers=1)
    lanes = [ex.new_lane(f"lane-{i}") for i in range(2)]
    arg = torch.ones(4)
    freed = weakref.ref(arg)
    out = ex.submit(lambda t: float(t.sum()), (arg,), lane=lanes[0])
    assert out.result(10) == 4.0
    del arg, out
    gc.collect()
    assert freed() is None
    slow = ex.submit(lambda: time.sleep(0.3) or "late", (), lane=lanes[1])
    ex.shutdown(wait=False)
    assert not any(lane._thread.is_alive() for lane in lanes)
    assert slow.result(0) == "late"


# ---------------------------------------------------------------------------
# Planes not ported yet are refused at init, before any state is built
# ---------------------------------------------------------------------------

_REFUSED = [
    ({"collective": {"coordinator": "127.0.0.1:1"}}, "item 12"),
    ({"cross_silo_comm": {"same_mesh_push": True}}, "item 12b"),
    ({"transport": "tpu"}, "item 4"),
    ({"transport": "grpc"}, "item 15"),
]


@pytest.mark.parametrize("config, item", _REFUSED,
                         ids=[f"{next(iter(c))}-{i[5:]}" for c, i in _REFUSED])
def test_unported_config_block_is_refused_at_init(config, item):
    from rayfed_tpu_torch._private.global_context import get_global_context
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    addresses = {"alice": "127.0.0.1:1"}
    with pytest.raises((NotImplementedError, ImportError), match=item):
        fed.init(addresses=addresses, party="alice", config=config)
    assert get_global_context() is None and not tenancy_context.contexts()


# The blocks of the planes ported since (ROADMAP items 10, 11b and 18): init
# accepts each and rejects a typo in it, before building any state, with
# the JAX package's message.
_ACCEPTED_BLOCKS = [
    ("membership", {"membership": {"join_timeout_s": 5.0}},
     {"membership": {"join_timeout": 5.0}},
     r"unknown membership config key\(s\) \['join_timeout'\]"),
    ("checkpoint", {"checkpoint": {"keep": 2}}, {"checkpoint": {"dir": "x"}},
     r"unknown checkpoint config key\(s\) \['dir'\]"),
    ("aggregation_async",
     {"aggregation": {"topology": "tree", "async_buffer_k": 2}},
     {"aggregation": {"topology": "tree", "async_bufer_k": 2}},
     r"unknown aggregation config key 'async_bufer_k'"),
    ("privacy", {"privacy": {"quantize": "int8", "clip_norm": 1.0}},
     {"privacy": {"quantise": "int8"}},
     r"unknown privacy config key 'quantise'"),
    ("wire_int8",
     {"cross_silo_comm": {"payload_wire_dtype": "int8"},
      "privacy": {"quantize": "int8"}},
     {"cross_silo_comm": {"payload_wire_dtype": "int8"}},
     r"payload_wire_dtype=\"int8\" requires the privacy plane"),
    ("telemetry",
     {"telemetry": {"collector": "alice", "push_interval_ms": 50,
                    "http_port": 0}},
     {"telemetry": {"collector": "alice", "push_interval": 50}},
     r"unknown telemetry config keys: \['push_interval'\]"),
]


@pytest.mark.parametrize("block, config, typo, message", _ACCEPTED_BLOCKS,
                         ids=[b for b, *_ in _ACCEPTED_BLOCKS])
def test_ported_config_block_is_accepted_and_its_typo_rejected(
        block, config, typo, message):
    from rayfed_tpu_torch._private.global_context import get_global_context
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    with pytest.raises(ValueError, match=message):
        fed.init(addresses={"alice": "127.0.0.1:1"}, party="alice",
                 config=typo)
    assert get_global_context() is None and not tenancy_context.contexts()
    fed.init(addresses=get_addresses(["alice"]), party="alice",
             config=config)
    try:
        if block == "membership":
            assert fed.membership_view().roster == ("alice",)
        elif block == "checkpoint":
            from rayfed_tpu_torch import checkpoint

            assert checkpoint.get_default_checkpoint_config().keep == 2
        elif block == "telemetry":
            view = fed.telemetry_snapshot()
            assert view["fleet"] is True and view["collector"] == "alice"
            assert view["endpoint"].startswith("http://127.0.0.1:")
        elif block in ("privacy", "wire_int8"):
            from rayfed_tpu_torch.privacy import get_privacy_manager

            assert get_privacy_manager().config.quantize == "int8"
            assert fed.privacy_ledger() == {}
        else:
            from rayfed_tpu_torch import async_rounds

            assert async_rounds.get_default_async_config().buffer_k == 2
    finally:
        fed.shutdown()
    assert get_global_context() is None


def _f32_head_dim_320():
    import torch

    from rayfed_tpu_torch.ops.flash_attention import kernel_head_dim

    kernel_head_dim(320, torch.float32)


def _bf16_head_dim_320():
    import torch

    from rayfed_tpu_torch.ops.flash_attention import kernel_head_dim

    kernel_head_dim(320, torch.bfloat16)


# Refusals that are calls, not config blocks: each names where its work
# stands in the ROADMAP.
_REFUSED_CALLS = [
    (_f32_head_dim_320, "Queue 2, 'head dims above 256'"),
    (_bf16_head_dim_320, "Queue 2, 'head dims above 256'"),
]


@pytest.mark.parametrize("call, item", _REFUSED_CALLS,
                         ids=["f32_head_dim_over_128",
                              "bf16_head_dim_over_256"])
def test_unported_call_is_refused(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


# ---------------------------------------------------------------------------
# Mirrors of test_reactor.py: the proxies and the reactor lane in-process
# ---------------------------------------------------------------------------

FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}


def test_proxy_pair_carries_a_tensor_tree_bitwise():
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
        TcpReceiverProxy,
        TcpSenderProxy,
    )

    addr = get_addresses(["alice", "bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = TcpSenderProxy(addr, "alice", "job", None, dict(FAST))
    sp.start()
    try:
        g = torch.Generator().manual_seed(3)
        tree = {"w": torch.randn(64, 33, generator=g).to(torch.bfloat16),
                "b": [torch.randn(5, generator=g), 4]}
        assert sp.send("bob", tree, "1#0", 1).result(timeout=30) is True
        got = rp.get_data("alice", "1#0", 1).result(timeout=30)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           tree["w"].view(torch.int16))
        assert torch.equal(got["b"][0], tree["b"][0]) and got["b"][1] == 4
    finally:
        sp.stop()
        rp.stop()


def test_receiver_survives_client_disconnect_mid_frame():
    from rayfed_tpu_torch.proxy.tcp import wire
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
        TcpReceiverProxy,
        TcpSenderProxy,
    )

    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = None
    try:
        host, port = addr["bob"].rsplit(":", 1)
        raw = socket.create_connection((host, int(port)), timeout=5)
        blob = wire.encode_prefix_and_header(
            wire.FTYPE_DATA, {"seq": "1#0", "fseq": 1}, 1000)
        raw.sendall(blob + b"x" * 100)  # then RST, mid-frame
        raw.close()
        time.sleep(0.2)
        sp = TcpSenderProxy(addr, "alice", "job", None, dict(FAST))
        sp.start()
        fut = sp.send("bob", {"a": torch.arange(8, dtype=torch.int32)},
                      "2#0", 2)
        assert fut.result(timeout=30) is True
        got = rp.get_data("alice", "2#0", 2).result(timeout=30)
        assert got["a"][3] == 3
    finally:
        if sp is not None:
            sp.stop()
        rp.stop()


def test_reactor_lane_burst_keeps_order_and_window():
    from rayfed_tpu_torch._private.constants import CODE_OK
    from rayfed_tpu_torch.proxy.tcp import reactor, sockio, wire

    if not reactor.available():
        pytest.skip("epoll not available on this platform")
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    frames = []

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(30)
        try:
            while True:
                _, header, _ = sockio.recv_frame(conn)
                frames.append(header["i"])
                sockio.send_frame(conn, wire.FTYPE_RESP,
                                  {"code": CODE_OK, "msg": "",
                                   "fseq": header.get("fseq")})
        except Exception:  # noqa: BLE001 - EOF ends the connection
            pass
        finally:
            conn.close()

    import threading

    threading.Thread(target=serve, daemon=True).start()
    lane = reactor.ReactorLane(
        "bob", lambda attempts: socket.create_connection(
            srv.getsockname(), timeout=5),
        max_attempts=3, ack_timeout_s=10.0, on_ack=lambda: None,
        window=4, small_threshold=0)
    try:
        futs = []
        for i in range(50):
            fut = Future()
            lane.submit(fut, {"seq": f"{i}#0", "i": i}, [b"x" * 256], 256)
            futs.append(fut)
        assert all(f.result(timeout=30) for f in futs)
        assert frames == list(range(50))
        deadline = time.monotonic() + 5
        while lane._window._value < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lane._window._value == 4
    finally:
        lane.close()
        srv.close()

