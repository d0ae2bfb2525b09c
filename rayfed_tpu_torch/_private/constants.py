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

"""Internal constants.

Mirrors the role of the reference's ``fed/_private/constants.py`` (key names
for the job-scoped KV, logging format) with our own naming.
"""

KEY_OF_CLUSTER_CONFIG = "CLUSTER_CONFIG"
KEY_OF_JOB_CONFIG = "JOB_CONFIG"

KEY_OF_CLUSTER_ADDRESSES = "CLUSTER_ADDRESSES"
KEY_OF_CURRENT_PARTY_NAME = "CURRENT_PARTY_NAME"
KEY_OF_TLS_CONFIG = "TLS_CONFIG"
KEY_OF_CROSS_SILO_COMM_CONFIG_DICT = "CROSS_SILO_COMM_CONFIG_DICT"

KV_NAMESPACE_PREFIX = "FEDTPU"

# Logging format: party and job name injected via logging.Filter, matching
# the observability surface of the reference (``fed/_private/constants.py:30``).
LOG_FORMAT = (
    "%(asctime)s %(levelname)s %(filename)s:%(lineno)s"
    " [%(party)s] -- [%(jobname)s] %(message)s"
)

DEFAULT_JOB_NAME = "default"

# Wire protocol (see rayfed_tpu_torch/proxy/tcp/wire.py).
WIRE_MAGIC = b"FTP1"
WIRE_VERSION = 1

# Response codes on the data plane — kept numerically compatible with the
# reference's HTTP-flavored codes (``fed/proxy/grpc/grpc_proxy.py:311-320``).
CODE_OK = 200
CODE_FORBIDDEN = 403  # peer cert does not attest the claimed src party
CODE_PICKLE_FORBIDDEN = 415  # strict arrays-only mode rejected the frame
CODE_JOB_MISMATCH = 417
# Receiver could not attach/adopt a same-host shared-memory descriptor
# (ring unlinked, cross-host misconfiguration, map failure). The sender
# treats it as a per-push demotion signal: resend on the socket lane and
# stop offering shm frames to this peer (proxy/lanes.py).
CODE_SHM_UNAVAILABLE = 424
# Frame-integrity NACK: the receiver's payload checksum (header "crc",
# algorithm id "crca") did not match the received bytes. The sender
# treats it as retryable — requeue the SAME frame for retransmission
# through the resend machinery (bounded by max_attempts); never a
# demotion signal and never a poisoned-decode crash.
CODE_DATA_CORRUPT = 409
CODE_INTERNAL_ERROR = 500

# Seq id used by the ping_others readiness barrier for both the upstream
# and downstream ids of a ping send — matches the reference's literal
# "ping"/"ping" pair on the wire (ref fed/proxy/barriers.py:497-523).
PING_SEQ_ID = "ping"
