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

"""FTP1: the native binary wire protocol of the TCP data plane.

Replaces the reference's single-RPC gRPC service
(``fed/grpc/fed.proto:5-19``: SendDataRequest{data, upstream_seq_id,
downstream_seq_id, job_name} -> SendDataResponse{code, result}) with a
length-prefixed binary framing that (a) carries the payload *outside* any
serialization envelope so array bytes are written straight from device
buffers, and (b) needs no protobuf codegen.

Frame layout (big-endian):

    magic   4s   b"FTP1"
    version u8
    ftype   u8   0 = DATA, 1 = RESP
    hlen    u32  msgpack header length
    plen    u64  payload length (0 for RESP)
    header  msgpack dict
    payload raw bytes

DATA header: {job, src, up, down, is_error, pkind, pmeta}
RESP header: {code, msg}   codes per reference: 200 OK, 417 job mismatch,
500 internal (ref ``grpc_proxy.py:311-342``).
"""

from __future__ import annotations

import ssl
import struct
from typing import Dict, Optional

from rayfed_tpu_torch._private import msgpack_codec as msgpack

from rayfed_tpu_torch._private.constants import WIRE_MAGIC, WIRE_VERSION

_PREFIX = struct.Struct(">4sBBIQ")
PREFIX_LEN = _PREFIX.size

FTYPE_DATA = 0
FTYPE_RESP = 1

# Hard sanity cap on a single frame payload (1 TiB) — real limits come from
# config (messages_max_size_in_bytes).
_MAX_PAYLOAD = 1 << 40
# Headers are tiny msgpack dicts; anything near this is an attack or a bug.
_MAX_HEADER = 64 * 1024 * 1024
# Response frames carry only {code, msg, fseq}.
MAX_RESP_FRAME = 1 << 20


class WireError(Exception):
    pass


def encode_prefix_and_header(ftype: int, header: Dict, payload_len: int) -> bytes:
    hdr = msgpack.packb(header, use_bin_type=True)
    return _PREFIX.pack(WIRE_MAGIC, WIRE_VERSION, ftype, len(hdr), payload_len) + hdr


def as_byte_view(buf) -> memoryview:
    view = memoryview(buf)
    if view.nbytes == 0:
        return memoryview(b"")
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    return view


# ---------------------------------------------------------------------------
# TLS (mutual) — parity with ref ``fed/utils.py:149-163`` +
# ``grpc_proxy.py:124-141,362-372``: both sides present certs signed by the
# shared CA; ICI is physically private, TLS protects the DCN/TCP control+data
# plane (SURVEY.md C16).
# ---------------------------------------------------------------------------


def tls_enabled(tls_config: Optional[Dict]) -> bool:
    return bool(tls_config)


def _check_tls_config(tls_config: Dict) -> None:
    missing = {"ca_cert", "cert", "key"} - set(tls_config)
    if missing:
        raise ValueError(f"tls_config missing keys: {sorted(missing)}")


def make_server_ssl_context(tls_config: Dict) -> ssl.SSLContext:
    _check_tls_config(tls_config)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=tls_config["cert"], keyfile=tls_config["key"])
    ctx.load_verify_locations(cafile=tls_config["ca_cert"])
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def peer_party_identities(ssl_sock) -> Optional[set]:
    """Identities (subject CN values + DNS SANs) attested by the peer's
    verified certificate, or None when no cert info is available.

    Used to bind the mTLS layer to the claimed ``src`` party: without this,
    any CA-signed party could impersonate another party's sends (all certs
    chain to the shared CA; ``check_hostname`` is off because party certs
    are named per party, not per host).

    Returns an EMPTY set — not None — when a cert is present but names no
    identity, so the caller fails closed (every src claim rejected) rather
    than open. None means no cert information was available at all."""
    try:
        cert = ssl_sock.getpeercert()
    except (ssl.SSLError, OSError, ValueError):
        return None
    if not cert:
        return None
    ids = set()
    for rdn in cert.get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                ids.add(value)
    for typ, value in cert.get("subjectAltName", ()):
        if typ == "DNS":
            ids.add(value)
    return ids


def make_client_ssl_context(tls_config: Dict) -> ssl.SSLContext:
    _check_tls_config(tls_config)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(certfile=tls_config["cert"], keyfile=tls_config["key"])
    ctx.load_verify_locations(cafile=tls_config["ca_cert"])
    # Party certs are CA-signed per party name, not per hostname.
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
