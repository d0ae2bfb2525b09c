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

"""The port's mutual TLS end to end, mirroring ``test_tls.py`` with the
same assertions and torch payloads: both parties present CA-signed
certs; data crosses encrypted; a cert-less client is rejected; a peer
whose cert names another party is refused. Beyond the mirror: a mixed
job (one party on the JAX package) pushes f32 and bf16 trees over TLS in
both directions and each arrives bitwise. Certificates come from
``tools/generate_tls_certs.py``."""

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from tests.utils import FAST_COMM_CONFIG, get_addresses, run_parties

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.generate_tls_certs import generate, tls_config_for  # noqa: E402


@fed.remote
def produce(v):
    return torch.full((1024,), v, dtype=torch.float32)


@fed.remote
def agg(a, b):
    return float((a + b).sum())


def run_tls(party, addresses, cert_dir):
    fed.init(
        addresses=addresses,
        party=party,
        tls_config=tls_config_for(cert_dir, party),
        config={"cross_silo_comm": dict(FAST_COMM_CONFIG)},
    )
    a = produce.party("alice").remote(1.0)
    b = produce.party("bob").remote(2.0)
    out = agg.party("bob").remote(a, b)
    assert fed.get(out) == 3.0 * 1024
    fed.shutdown()


def test_tls_two_party(tmp_path):
    cert_dir = str(tmp_path / "certs")
    generate(cert_dir, ["alice", "bob"])
    run_parties(run_tls, ["alice", "bob"], extra_args=(cert_dir,), timeout=180)


def test_certless_client_rejected(tmp_path):
    """A TLS server must refuse a plaintext/cert-less peer."""
    import socket
    import ssl
    import threading

    cert_dir = str(tmp_path / "certs")
    generate(cert_dir, ["alice", "bob"])
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy

    addr = get_addresses(["alice"])["alice"]
    rp = TcpReceiverProxy(
        addr, "alice", "job", tls_config_for(cert_dir, "alice"), {}
    )
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    host, port = addr.rsplit(":", 1)

    # Plaintext probe: server should drop it without crashing.
    s = socket.create_connection((host, int(port)), timeout=5)
    s.sendall(b"GARBAGE-NOT-TLS")
    s.close()

    # TLS probe without a client cert: handshake must fail.
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    raw = socket.create_connection((host, int(port)), timeout=5)
    tls = ctx.wrap_socket(raw)
    # Under TLS 1.3 the client-cert rejection surfaces on the first read
    # (the server sends an alert and closes) rather than during wrap.
    rejected = False
    try:
        tls.sendall(b"x" * 64)
        rejected = tls.recv(1) == b""
    except (ssl.SSLError, ConnectionError, OSError):
        rejected = True
    assert rejected, "server accepted a cert-less TLS client"
    tls.close()
    rp.stop()


def test_peer_cert_must_attest_claimed_src_party(tmp_path):
    """mTLS party binding (ADVICE r1): a CA-signed peer whose certificate
    names one party cannot push frames claiming to be another party."""
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy

    cert_dir = str(tmp_path / "certs")
    generate(cert_dir, ["alice", "bob", "carol"])
    addr = get_addresses(["bob"])
    fast = dict(FAST_COMM_CONFIG)
    rp = TcpReceiverProxy(
        addr["bob"], "bob", "job", tls_config_for(cert_dir, "bob"), fast
    )
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err

    # Impersonation: the sender presents carol's cert but claims src=alice.
    impostor = TcpSenderProxy(
        addr, "alice", "job", tls_config_for(cert_dir, "carol"), fast
    )
    impostor.start()
    fut = impostor.send("bob", torch.ones(8, dtype=torch.float32), "1#0", 2)
    with pytest.raises(RuntimeError, match="403"):
        fut.result(timeout=60)
    # Nothing may have been buffered for the waiter.
    parked = rp.get_data("alice", "1#0", 2)
    assert not parked.done()
    impostor.stop()

    # Control: the honest alice cert passes.
    honest = TcpSenderProxy(
        addr, "alice", "job", tls_config_for(cert_dir, "alice"), fast
    )
    honest.start()
    assert honest.send("bob", torch.ones(8, dtype=torch.float32), "1#0", 2).result(
        timeout=60
    )
    assert parked.result(timeout=60)[0] == 1.0
    honest.stop()
    rp.stop()


def test_peer_identity_check_can_be_disabled(tmp_path):
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy

    cert_dir = str(tmp_path / "certs")
    generate(cert_dir, ["alice", "bob"])
    addr = get_addresses(["bob"])
    cfg = dict(FAST_COMM_CONFIG, verify_peer_identity=False)
    rp = TcpReceiverProxy(
        addr["bob"], "bob", "job", tls_config_for(cert_dir, "bob"), cfg
    )
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = TcpSenderProxy(
        addr, "carol", "job", tls_config_for(cert_dir, "alice"), cfg
    )
    sp.start()
    fut = rp.get_data("carol", "1#0", 2)
    assert sp.send("bob", torch.ones(4, dtype=torch.float32), "1#0", 2).result(timeout=60)
    assert fut.result(timeout=60)[0] == 1.0
    sp.stop()
    rp.stop()


# ---------------------------------------------------------------------------
# Mixed packages over TLS
# ---------------------------------------------------------------------------

MIXED = {
    "alice_jax-bob_torch": {"alice": "jax", "bob": "torch"},
    "alice_torch-bob_jax": {"alice": "torch", "bob": "jax"},
}


def _numpy_tree(seed):
    """A party's tree as numpy: f32 leaves and the bits (uint16) of a
    bf16 leaf."""
    rng = np.random.default_rng(seed)
    bits = rng.standard_normal(777).astype(np.float32).view(np.uint32)
    bf16 = ((bits + (0x7FFF + ((bits >> 16) & 1))) >> 16).astype(np.uint16)
    return {"w": rng.standard_normal((64, 33)).astype(np.float32),
            "layers": [{"h": bf16}]}


def _to_package(tree, pkg):
    if pkg == "jax":
        import ml_dtypes

        return {"w": tree["w"],
                "layers": [{"h": tree["layers"][0]["h"].view(
                    ml_dtypes.bfloat16)}]}
    return {"w": torch.from_numpy(tree["w"].copy()),
            "layers": [{"h": torch.from_numpy(
                tree["layers"][0]["h"].view(np.int16).copy()
            ).view(torch.bfloat16)}]}


def _leaf_bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def run_mixed_tls(party, addresses, cert_dir, pkgs):
    pkg = pkgs[party]
    if pkg == "jax":
        import rayfed_tpu as mfed
    else:
        import rayfed_tpu_torch as mfed
    trees = {"alice": _numpy_tree(1), "bob": _numpy_tree(2)}

    def produce_tree(p):
        return _to_package(trees[p], pkg)

    def leaf_hex(t):
        return [_leaf_bytes(t["w"]).hex(),
                _leaf_bytes(t["layers"][0]["h"]).hex()]

    produce_remote = mfed.remote(produce_tree)
    hex_remote = mfed.remote(leaf_hex)
    mfed.init(
        addresses=addresses,
        party=party,
        tls_config=tls_config_for(cert_dir, party),
        config={"cross_silo_comm": dict(FAST_COMM_CONFIG)},
    )
    a = produce_remote.party("alice").remote("alice")
    b = produce_remote.party("bob").remote("bob")
    # Each tree is read where it was pushed to, in the other package.
    got_at_bob = mfed.get(hex_remote.party("bob").remote(a))
    got_at_alice = mfed.get(hex_remote.party("alice").remote(b))
    for name, got in (("alice", got_at_bob), ("bob", got_at_alice)):
        want = trees[name]
        assert got[0] == want["w"].tobytes().hex(), name
        assert got[1] == want["layers"][0]["h"].tobytes().hex(), name
    mfed.shutdown()


@pytest.mark.parametrize("direction", sorted(MIXED))
def test_tls_push_between_packages_arrives_bitwise(tmp_path, direction):
    cert_dir = str(tmp_path / "certs")
    generate(cert_dir, ["alice", "bob"])
    run_parties(run_mixed_tls, ["alice", "bob"],
                extra_args=(cert_dir, MIXED[direction]), timeout=180)
