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

"""The serving cases of ``test_tenancy.py`` on the port: the KV block
quota at server registration (a slab pool charges its slots up front, a
paged pool charges per block grant), on the CPU."""

import pytest
import torch

from rayfed_tpu_torch.config import ServingConfig
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.serving import server as serving_server
from rayfed_tpu_torch.tenancy import context as tenancy
from rayfed_tpu_torch.tenancy import qos as tenancy_qos
from rayfed_tpu_torch.tenancy.context import TenancyConfig, TenantQuotaExceeded


def test_kv_block_quota_enforced_at_server_registration():
    ctx = tenancy.create_context(
        "quota_kv", "alice", tenancy=TenancyConfig(kv_block_quota=4))

    class _StubPool:
        max_slots = 8

    class _StubServer:
        name = "stub"
        pool = _StubPool()

        def stop(self, timeout=10.0):
            pass

    try:
        with tenancy.use_context(ctx):
            with pytest.raises(TenantQuotaExceeded) as exc:
                serving_server.register_server(_StubServer())
            assert exc.value.resource == "kv_blocks"
            # Under quota: registers, and unregister releases the charge.
            _StubPool.max_slots = 4
            serving_server.register_server(_StubServer())
            assert tenancy_qos.get_ledger().in_use(
                "quota_kv", "kv_blocks") == 4
            serving_server.unregister_server("stub")
            assert tenancy_qos.get_ledger().in_use(
                "quota_kv", "kv_blocks") == 0
    finally:
        tenancy.remove_context("quota_kv")


@pytest.mark.parametrize("layout, charged", [("slab", 3), ("paged", 0)])
def test_real_server_registration_charges_by_layout(layout, charged):
    """A slab server pins its slots at registration; a paged one charges
    nothing until it grants blocks. ``stop_all_servers`` (fed.shutdown's
    hook) releases the slab charge."""
    cfg = tfm.tiny_config(compute_dtype=torch.float32)
    ctx = tenancy.create_context(
        "quota_real", "alice", tenancy=TenancyConfig(kv_block_quota=3))
    try:
        with tenancy.use_context(ctx):
            srv = serving_server.InferenceServer(
                cfg, ServingConfig(max_slots=3, max_len=16, max_new_tokens=4,
                                   kv_layout=layout),
                params=tfm.init_params(0, cfg, device="cpu"), device="cpu",
                name="real")
            serving_server.register_server(srv)
            ledger = tenancy_qos.get_ledger()
            assert ledger.in_use("quota_real", "kv_blocks") == charged
            assert serving_server.get_server("real") is srv
            assert len(srv.submit_and_wait([1, 2, 3])["tokens"]) == 4
            serving_server.stop_all_servers()
            assert ledger.in_use("quota_real", "kv_blocks") == 0
            with pytest.raises(RuntimeError, match="no serving engine"):
                serving_server.get_server("real")
    finally:
        tenancy.remove_context("quota_real")
