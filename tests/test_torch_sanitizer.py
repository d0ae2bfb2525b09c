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

"""The port's FedSanitizer, mirroring the ported probes of
``test_sanitizer.py`` with the same assertions: every probe trips when
its invariant is forced, stays silent on legal sequences, and the whole
suite is inert when disabled. The JAX package's ``donation-aliasing``
probe (deleted jax buffers) is left out of the port, and its two tests
with it (ROADMAP Queue 3's divergence).

The closing chaos test runs a real 3-party FedAvg of torch logreg
models twice — baseline and under ``FEDTPU_SANITIZE=1`` — and asserts
zero trips plus bitwise-identical aggregated weights: the sanitizer must
never change program results, only observe them (docs/sanitizer.md).
"""

import hashlib
import os
import threading

import numpy as np
import pytest

from rayfed_tpu_torch import sanitize
from rayfed_tpu_torch.sanitize import SanitizerError
from tests.utils import FAST_COMM_CONFIG, run_parties


@pytest.fixture
def sanitizer():
    """Probes on, state clean; restore the env-derived switch after."""
    was_enabled = sanitize.enabled()
    sanitize.reset()
    sanitize.enable()
    yield sanitize
    sanitize.reset()
    if not was_enabled:
        sanitize.disable()


# ----------------------------------------------------------------------
# the enabled switch
# ----------------------------------------------------------------------

def test_probes_are_noops_when_disabled():
    sanitize.reset()
    sanitize.disable()
    try:
        sanitize.probe_send_seq("bob", 5, 0)
        sanitize.probe_send_seq("bob", 1, 0)  # regression: ignored
        sanitize.probe_rendezvous_reoccupation(("a", "b"), "alice", "carol")
        sanitize.probe_shm_adopt(1, 0, 64)
        sanitize.probe_shm_cancel(1, 0, 64)
        sanitize.probe_inline_busy_set(7)
        sanitize.probe_inline_busy_clear(8)  # clear-without-set: ignored
        sanitize.probe_reactor_affinity(threading.Thread(), "x")
        assert sanitize.trips() == {}
    finally:
        sanitize.reset()
        if os.environ.get("FEDTPU_SANITIZE") == "1":
            sanitize.enable()


def test_sanitizer_error_names_the_check(sanitizer):
    with pytest.raises(SanitizerError) as exc:
        sanitize.probe_send_seq("bob", 3, None) or sanitize.probe_send_seq(
            "bob", 1, None
        )
    assert exc.value.check == "seq-monotonicity"
    assert "seq-monotonicity" in str(exc.value)


# ----------------------------------------------------------------------
# seq-monotonicity
# ----------------------------------------------------------------------

def test_seq_monotonicity_allows_nondecreasing(sanitizer):
    sanitize.probe_send_seq("bob", 1, 0)
    sanitize.probe_send_seq("bob", 1, 0)  # equal: several args, one get
    sanitize.probe_send_seq("bob", 4, 0)
    assert sanitize.trips() == {}


def test_seq_monotonicity_trips_on_regression(sanitizer):
    sanitize.probe_send_seq("bob", 9, 0)
    with pytest.raises(SanitizerError, match="seq-monotonicity"):
        sanitize.probe_send_seq("bob", 8, 0)
    assert sanitize.trips() == {"seq-monotonicity": 1}


def test_seq_monotonicity_is_per_party_and_epoch(sanitizer):
    sanitize.probe_send_seq("bob", 9, 0)
    # A different dest party and a new epoch each start fresh.
    sanitize.probe_send_seq("carol", 1, 0)
    sanitize.probe_send_seq("bob", 1, 1)
    assert sanitize.trips() == {}


# ----------------------------------------------------------------------
# rendezvous-reoccupation
# ----------------------------------------------------------------------

def test_rendezvous_same_src_substitution_is_legal(sanitizer):
    # Error-envelope substitution: same src may replace its parked frame.
    sanitize.probe_rendezvous_reoccupation(("3", "4"), "alice", "alice")
    assert sanitize.trips() == {}


def test_rendezvous_cross_src_reoccupation_trips(sanitizer):
    with pytest.raises(SanitizerError, match="rendezvous-reoccupation"):
        sanitize.probe_rendezvous_reoccupation(("3", "4"), "alice", "carol")
    assert sanitize.trips() == {"rendezvous-reoccupation": 1}


# ----------------------------------------------------------------------
# shm ring probes (through the real Python ring)
# ----------------------------------------------------------------------

@pytest.fixture
def py_ring():
    from rayfed_tpu_torch.proxy.lanes import _PyShmRing

    name = f"fedtpu-sanitize-test-{os.getpid()}"
    ring = _PyShmRing.create(name, 4096)
    yield ring
    try:
        ring.close()
    except OSError:
        pass


def test_shm_adopt_once_is_clean(sanitizer, py_ring):
    off = py_ring.push([b"payload"])
    assert off is not None
    assert bytes(py_ring.adopt(off, 7)) == b"payload"
    assert sanitize.trips() == {}


def test_shm_double_adopt_trips(sanitizer, py_ring):
    off = py_ring.push([b"payload"])
    py_ring.adopt(off, 7)
    with pytest.raises(SanitizerError, match="shm-use-after-release"):
        py_ring.adopt(off, 7)
    assert sanitize.trips() == {"shm-use-after-release": 1}


def test_shm_double_cancel_trips(sanitizer, py_ring):
    off = py_ring.push([b"payload"])
    py_ring.cancel(off)
    with pytest.raises(SanitizerError, match="shm-double-release"):
        py_ring.cancel(off)


def test_shm_adopt_after_cancel_trips(sanitizer, py_ring):
    off = py_ring.push([b"payload"])
    py_ring.cancel(off)
    with pytest.raises(SanitizerError, match="shm-use-after-release"):
        py_ring.adopt(off, 7)


def test_shm_probes_off_keep_reference_errors(py_ring):
    """Disabled, the ring's own ValueError contract is unchanged."""
    sanitize.reset()
    sanitize.disable()
    try:
        off = py_ring.push([b"payload"])
        py_ring.adopt(off, 7)
        with pytest.raises(ValueError):
            py_ring.adopt(off, 7)
    finally:
        if os.environ.get("FEDTPU_SANITIZE") == "1":
            sanitize.enable()


# ----------------------------------------------------------------------
# inline-busy ownership
# ----------------------------------------------------------------------

def test_inline_busy_same_thread_roundtrip(sanitizer):
    sanitize.probe_inline_busy_set(42)
    sanitize.probe_inline_busy_clear(42)
    sanitize.probe_inline_busy_set(42)  # reusable after a clean clear
    sanitize.probe_inline_busy_clear(42)
    assert sanitize.trips() == {}


def test_inline_busy_double_set_trips(sanitizer):
    sanitize.probe_inline_busy_set(42)
    with pytest.raises(SanitizerError, match="inline-busy-ownership"):
        sanitize.probe_inline_busy_set(42)


def test_inline_busy_cross_thread_clear_trips(sanitizer):
    sanitize.probe_inline_busy_set(42)
    caught = []

    def clear_from_other_thread():
        try:
            sanitize.probe_inline_busy_clear(42)
        except SanitizerError as e:
            caught.append(e)

    t = threading.Thread(target=clear_from_other_thread)
    t.start()
    t.join()
    assert len(caught) == 1 and caught[0].check == "inline-busy-ownership"


# ----------------------------------------------------------------------
# reactor thread affinity
# ----------------------------------------------------------------------

def test_reactor_affinity_on_loop_thread_is_clean(sanitizer):
    sanitize.probe_reactor_affinity(threading.current_thread(), "_pump")
    assert sanitize.trips() == {}


def test_reactor_affinity_off_thread_trips(sanitizer):
    not_me = threading.Thread(name="fedtpu-reactor-fake", target=lambda: None)
    with pytest.raises(SanitizerError, match="reactor-thread-affinity"):
        sanitize.probe_reactor_affinity(not_me, "ReactorLane._pump")


# ----------------------------------------------------------------------
# telemetry and state management
# ----------------------------------------------------------------------

def test_trip_increments_telemetry_counter(sanitizer):
    from rayfed_tpu_torch.telemetry.metrics import get_registry

    metric = get_registry().counter(
        "fed_sanitizer_trips_total",
        "FedSanitizer invariant trips by check name.",
        labels=("check",),
    )
    before = metric.labels(check="rendezvous-reoccupation").value()
    with pytest.raises(SanitizerError):
        sanitize.probe_rendezvous_reoccupation(("1", "2"), "a", "b")
    after = metric.labels(check="rendezvous-reoccupation").value()
    assert after == before + 1


def test_reset_clears_probe_state_and_trips(sanitizer):
    sanitize.probe_send_seq("bob", 9, 0)
    with pytest.raises(SanitizerError):
        sanitize.probe_send_seq("bob", 1, 0)
    sanitize.reset()
    assert sanitize.trips() == {}
    # The watermark is gone: the old regression is a fresh first send.
    sanitize.probe_send_seq("bob", 1, 0)


# ----------------------------------------------------------------------
# seam wiring: barriers.send runs the probe on real sends
# ----------------------------------------------------------------------

def test_barriers_send_seam_calls_probe(sanitizer, monkeypatch):
    """The send() seam forwards (dest, seq, epoch) into the probe for
    plain integer seq ids and skips error envelopes."""
    from rayfed_tpu_torch.proxy import barriers

    seen = []
    monkeypatch.setattr(
        sanitize, "probe_send_seq",
        lambda dest, seq, epoch: seen.append((dest, seq, epoch)),
    )

    class _Proxy:
        def send(self, *args, **kwargs):
            return True

    barriers.set_seq_epoch_fn(lambda: 7)
    barriers._sender_proxies.set(_Proxy())
    try:
        barriers.send("bob", b"x", 1, 5)
        assert seen == [("bob", 5, 7)]
        barriers.send("bob", b"x", 1, 6, is_error=True)
        assert seen == [("bob", 5, 7)]  # error envelopes are exempt
    finally:
        barriers._sender_proxies.pop()
        barriers.clear_seq_epoch_fn()


# ----------------------------------------------------------------------
# chaos: 3-party FedAvg, sanitized == baseline, zero trips
# ----------------------------------------------------------------------

DIM, CLASSES, BATCH = 32, 4, 16
PARTIES = ["alice", "bob", "carol"]


def run_fedavg_3p(party, addresses, digest_dir):
    import rayfed_tpu_torch as fed

    fed.init(
        addresses=addresses,
        party=party,
        config={"cross_silo_comm": dict(FAST_COMM_CONFIG)},
    )

    import torch

    from rayfed_tpu_torch.models.mlp import init_logreg, logreg_loss
    from rayfed_tpu_torch.ops.aggregate import tree_mean

    seeds = {"alice": 1, "bob": 2, "carol": 3}

    @fed.remote
    class Worker:
        def __init__(self, seed):
            self.params = init_logreg(0, DIM, CLASSES, device="cpu")
            rng = np.random.default_rng(seed)
            self.x = torch.from_numpy(
                rng.normal(size=(BATCH, DIM)).astype(np.float32))
            self.y = torch.from_numpy(rng.integers(0, CLASSES, size=(BATCH,)))

        def train(self, global_params):
            if global_params is not None:
                self.params = global_params
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in self.params.items()}
            loss = logreg_loss(params, self.x, self.y)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                self.params = {k: p - 0.1 * g for (k, p), g
                               in zip(params.items(), grads)}
            return self.params

    @fed.remote
    def fedavg(wa, wb, wc):
        return tree_mean(wa, wb, wc)

    workers = {
        p: Worker.party(p).remote(seed=seeds[p]) for p in PARTIES
    }
    global_params = None
    for _ in range(2):
        pushes = [workers[p].train.remote(global_params) for p in PARTIES]
        global_params = fedavg.party("alice").remote(*pushes)
    final = fed.get(global_params)

    # Zero trips: a correct run must sail through every probe. Snapshot
    # BEFORE shutdown — fed.shutdown() resets sanitizer state.
    trips = dict(sanitize.trips())
    assert trips == {}, f"sanitizer tripped during clean FedAvg: {trips}"
    fed.shutdown()

    digest = hashlib.sha256(
        np.asarray(final["w"]).tobytes() + np.asarray(final["b"]).tobytes()
    ).hexdigest()
    import pathlib

    mode = "on" if sanitize.enabled() else "off"
    (pathlib.Path(digest_dir) / f"{party}.{mode}.digest").write_text(digest)


def test_chaos_fedavg_sanitized_matches_baseline(tmp_path, monkeypatch):
    monkeypatch.delenv("FEDTPU_SANITIZE", raising=False)
    run_parties(run_fedavg_3p, PARTIES, extra_args=(str(tmp_path),),
                timeout=240)
    monkeypatch.setenv("FEDTPU_SANITIZE", "1")
    run_parties(run_fedavg_3p, PARTIES, extra_args=(str(tmp_path),),
                timeout=240)

    digests = {
        (p, mode): (tmp_path / f"{p}.{mode}.digest").read_text()
        for p in PARTIES
        for mode in ("off", "on")
    }
    # Every party agrees, and the sanitizer changed nothing bitwise.
    assert len(set(digests.values())) == 1, digests
