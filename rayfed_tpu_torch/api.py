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

"""Public API: init / remote / get / kill / shutdown.

Capability parity: reference ``fed/api.py`` —
``init`` (api.py:67-297), ``shutdown``/``_shutdown`` (299-361),
``remote`` decorator + FedRemoteFunction/FedRemoteClass (384-528),
``get`` (531-608), ``kill`` (611-623), SIGINT hook (53-64,233).

Differences from the reference (SURVEY.md §7):
 - no Ray: tasks run on the party-local executor, actors on serial lanes;
 - the transport is the native TCP data plane with the array fast path
   (``transport='tcp'``), whose frames are the JAX package's, so parties
   of the two packages run one job together; ``torch.Tensor`` leaves ride
   it, CUDA tensors staged to host when the pushed value resolves;
 - ``transport='cuda'`` (the JAX package's ``'tpu'``) additionally places
   received tensors on the party's card, bound by ``init`` from
   ``config['party_mesh']`` (one device) or the current card;
 - a party over several processes (``config['jax_distributed']``) joins a
   ``torch.distributed`` group (``mesh.init_distributed``) in place of
   the JAX coordination service; its leader (process 0) owns the wire and
   relays what it receives to the followers over the group. The group
   outlives ``shutdown``, as ``jax.distributed``'s does.

This package ports the JAX package's engine without the planes still to
port (ROADMAP Queue 1): ``init`` refuses their config blocks, before any
state is built, with an error naming the item that brings each. The
user's tasks choose their device; the engine moves a tensor to the CPU
only to stage it for the wire.
"""

from __future__ import annotations

import inspect
import logging
import pickle
import signal
import threading
import sys
from typing import Any, Callable, Dict, List, Optional, Union

import rayfed_tpu_torch._private.constants as constants
import rayfed_tpu_torch.config as fed_config
import rayfed_tpu_torch.utils as fed_utils
from rayfed_tpu_torch import sanitize
from rayfed_tpu_torch._private import executor
from rayfed_tpu_torch._private import kv as internal_kv
from rayfed_tpu_torch._private.call_holder import FedCallHolder
from rayfed_tpu_torch._private.fed_actor import FedActorHandle
from rayfed_tpu_torch._private.global_context import (
    clear_global_context,
    get_global_context,
    init_global_context,
)
from rayfed_tpu_torch.config import CrossSiloMessageConfig
from rayfed_tpu_torch.exceptions import FedRemoteError
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.proxy import barriers
from rayfed_tpu_torch.utils import setup_logger

logger = logging.getLogger(__name__)

# Config blocks of planes this package has not ported yet -> the ROADMAP
# Queue 1 item that brings each. None of them is stubbed to succeed.
_UNPORTED_BLOCKS = {
    "collective": (
        "the cross-party collective lane is ROADMAP Queue 1 item 12b"
    ),
}


def _refuse_unported(config: Dict, transport: str) -> None:
    """Raise for any config block (or transport) of a plane this package
    does not have yet, naming its ROADMAP item."""
    for key, why in _UNPORTED_BLOCKS.items():
        if config.get(key) is not None:
            raise NotImplementedError(
                f"config[{key!r}] is not supported by rayfed_tpu_torch yet: "
                f"{why}"
            )
    comm = config.get("cross_silo_comm") or {}
    if isinstance(comm, dict) and comm.get("same_mesh_push"):
        # The lane negotiation would report the meshref tier while every
        # byte rode the socket.
        raise NotImplementedError(
            "cross_silo_comm.same_mesh_push is not supported by "
            "rayfed_tpu_torch yet: the same-mesh push lane is ROADMAP "
            "Queue 1 item 12b"
        )
    if transport != "tcp":
        # The proxy table raises the item-naming ImportError for 'tpu'
        # and 'grpc' (ValueError for unknown names).
        from rayfed_tpu_torch.proxy import lanes

        lanes.transport_proxy_classes(transport)


original_sigint = signal.getsignal(signal.SIGINT)


def _signal_handler(signum, frame):
    if signum == signal.SIGINT:
        signal.signal(signal.SIGINT, original_sigint)
        logger.warning(
            "Interrupt caught - draining pending cross-party sends before "
            "exit; interrupt again to abort the drain."
        )
        _shutdown(intended=False)


def init(
    addresses: Optional[Dict[str, str]] = None,
    party: Optional[str] = None,
    config: Optional[Dict] = None,
    tls_config: Optional[Dict] = None,
    logging_level: str = "info",
    sender_proxy_cls=None,
    receiver_proxy_cls=None,
    receiver_sender_proxy_cls=None,
    job_name: Optional[str] = None,
    sending_failure_handler: Optional[Callable[[Exception], None]] = None,
    transport: Optional[str] = None,
):
    """Initialize this party's fed runtime.

    Args:
        addresses: ``{party: "host:port"}`` for every party in the job.
        party: this party's name (must be a key of ``addresses``).
        config: job configuration dict; supported keys:
            ``cross_silo_comm`` (see :class:`CrossSiloMessageConfig` /
            :class:`~rayfed_tpu_torch.config.TcpCrossSiloMessageConfig`),
            ``barrier_on_initializing`` (bool: block until all parties are
            reachable), ``resilience`` (fault schedule, liveness),
            ``tenancy``, ``kv_store``, ``aggregation`` (``topology``,
            ``group_size``: the job's ``fed_aggregate`` default),
            ``party_mesh`` (``device_ids``: the party's one card),
            ``serving`` (:class:`~rayfed_tpu_torch.config.ServingConfig`
            keys: the job default of ``fed.serve``), ``membership``
            (:class:`~rayfed_tpu_torch.membership.MembershipConfig`),
            ``checkpoint`` (:class:`~rayfed_tpu_torch.checkpoint.CheckpointConfig`),
            ``privacy`` (:class:`~rayfed_tpu_torch.privacy.PrivacyConfig`:
            secure aggregation, DP clipping and noise, the int8
            quantizer; ``cross_silo_comm.payload_wire_dtype="int8"``
            needs ``privacy.quantize="int8"``) and the
            ``aggregation.async_*`` keys; each is
            validated strictly before any state is built, and so is
            ``telemetry`` (:class:`~rayfed_tpu_torch.telemetry.config.TelemetryConfig`:
            the per-party agent, and the collector with its optional
            HTTP endpoint at the collector party).
            ``jax_distributed`` (``coordinator_address``,
            ``num_processes``, ``process_id``, optional
            ``local_device_ids``) makes this process one of a party's
            processes: process 0, the leader, owns the wire, the KV's
            clearing and the resilience, membership, privacy and
            telemetry planes; a ``party_mesh`` over several devices then
            spans the party group's ranks. The block of the plane not
            ported yet (``collective``) is refused.
        tls_config: ``{ca_cert, cert, key}`` file paths for mutual TLS.
        logging_level: root logging level.
        sender_proxy_cls / receiver_proxy_cls: custom transport classes
            (the pluggable seam, ref api.py:73-75).
        receiver_sender_proxy_cls: a combined transport serving both
            directions behind the party's single advertised port (ref
            api.py:239-248); overrides the separate sender/receiver
            classes. ``cross_silo_comm.use_global_proxy=False`` registers
            proxies under job-suffixed names so several jobs' proxies
            coexist in one process (ref barriers.py:31-85).
        job_name: multi-job isolation name; peers in other jobs get 417.
        sending_failure_handler: called with the last sending error on
            unintended shutdown.
        transport: 'tcp' (the default) or 'cuda' (received tensors
            placed on the party's card; raises without one).
    """
    assert addresses, "fed.init needs addresses={party: 'host:port', ...}"
    assert party, "fed.init needs party=<this party's name>"
    assert party in addresses, (
        f"party {party!r} has no entry in addresses ({sorted(addresses)})"
    )
    config = config or {}
    transport = transport or config.get("transport", "tcp")
    comm_dict = config.get("cross_silo_comm") or {}
    # A party over several processes: config['jax_distributed'] =
    # {coordinator_address, num_processes, process_id} joins THIS party's
    # processes into one torch.distributed group. Process 0 is the party
    # leader: it alone owns the wire; followers run the same program.
    jax_dist = config.get("jax_distributed")
    party_process_id = int(jax_dist.get("process_id", 0)) if jax_dist else 0
    party_num_processes = (
        int(jax_dist.get("num_processes", 1)) if jax_dist else 1
    )
    if config.get("collective") is not None and party_num_processes > 1:
        raise ValueError(
            "config['collective'] and a multi-host party "
            "(config['jax_distributed']) cannot share a process: the "
            "party's private process group would be mistaken for the "
            "joint all-parties group. Aggregate multi-host parties over "
            "the push lane."
        )
    if (
        transport == "grpc"
        and isinstance(comm_dict, dict)
        and comm_dict.get("allow_pickle_payloads") is False
    ):
        # A contradiction in the job's config, whichever lanes exist: the
        # JAX package's message, before the transport's refusal below.
        raise ValueError(
            "allow_pickle_payloads=False is incompatible with "
            "transport='grpc': the gRPC parity lane pickles every payload "
            "by design. Use the native 'tcp'/'cuda' transports for strict "
            "arrays-only mode."
        )
    _refuse_unported(config, transport)
    # Validated before any state is built, so a bad serving key rejects
    # init here rather than at the first fed.serve — and the same for the
    # job-checkpoint section (a typo'd retention key must not surface at
    # the round-N save_job_state that was to make the job restartable),
    # the membership section and the aggregation.async_* keys.
    serving_dict = config.get("serving")
    if serving_dict is not None:
        fed_config.ServingConfig.from_dict(serving_dict)
    checkpoint_dict = config.get("checkpoint")
    if checkpoint_dict is not None:
        from rayfed_tpu_torch.checkpoint import CheckpointConfig

        CheckpointConfig.from_dict(checkpoint_dict)
    membership_dict = config.get("membership")
    membership_cfg = None
    if membership_dict is not None:
        from rayfed_tpu_torch.membership import MembershipConfig

        membership_cfg = MembershipConfig.from_dict(membership_dict)
    # The privacy block is STRICT: a typo'd privacy.* key rejects init
    # (a job must not silently run without the protection it asked for),
    # and the int8 wire tier is refused unless the privacy plane's
    # quantizer is on.
    privacy_dict = config.get("privacy")
    privacy_cfg = None
    if privacy_dict is not None:
        from rayfed_tpu_torch.privacy.config import PrivacyConfig

        privacy_cfg = PrivacyConfig.from_dict(privacy_dict)
    from rayfed_tpu_torch.privacy.config import validate_wire_dtype_gate

    validate_wire_dtype_gate(
        (config.get("cross_silo_comm") or {}).get("payload_wire_dtype"),
        privacy_dict,
    )
    telemetry_dict = config.get("telemetry")
    telemetry_cfg = None
    if telemetry_dict is not None:
        from rayfed_tpu_torch.telemetry.config import TelemetryConfig

        telemetry_cfg = TelemetryConfig.from_dict(telemetry_dict)
    aggregation_dict = config.get("aggregation") or {}
    if aggregation_dict:
        from rayfed_tpu_torch import async_rounds as _async_rounds

        _async_rounds.validate_async_config(aggregation_dict)
    # The party's device: bound when the job places on it (transport
    # 'cuda'), names it (party_mesh) or spans several processes;
    # resolved here so a mesh over several devices in one process, or no
    # card at all, is refused before any state is built.
    party_mesh_dict = config.get("party_mesh")
    party_mesh_cfg = None
    local_device_ids = (jax_dist or {}).get("local_device_ids")
    binds_device = (party_mesh_dict is not None or transport == "cuda"
                    or jax_dist is not None)
    if binds_device:
        from rayfed_tpu_torch import mesh as fed_mesh

        if party_mesh_dict is not None:
            party_mesh_cfg = fed_config.PartyMeshConfig.from_dict(
                party_mesh_dict)
        fed_mesh.resolve_party_device(
            party_mesh_cfg, num_processes=party_num_processes,
            local_device_ids=local_device_ids)

    if job_name is None:
        job_name = constants.DEFAULT_JOB_NAME

    fed_utils.validate_addresses(addresses)

    cross_silo_comm_dict = config.get("cross_silo_comm", {})
    cross_silo_comm_config = CrossSiloMessageConfig.from_dict(cross_silo_comm_dict)

    # The tenancy section is STRICT too: a typo'd quota key must reject
    # init here — a tenant silently running unbounded defeats the whole
    # QoS/quota contract (docs/multitenancy.md).
    from rayfed_tpu_torch.tenancy.context import TenancyConfig

    tenancy_dict = config.get("tenancy")
    tenancy_cfg = (
        TenancyConfig.from_dict(tenancy_dict)
        if tenancy_dict is not None
        else None
    )
    # Tenancy plane first: the FedContext is the per-job home every other
    # plane's JobScoped state resolves through, so it must exist (and be
    # bound to this thread) before anything below builds state. Also
    # registers the job with the weighted-fair transport scheduler.
    from rayfed_tpu_torch.tenancy import context as tenancy_context
    from rayfed_tpu_torch.tenancy import qos as tenancy_qos

    fed_ctx = tenancy_context.create_context(
        job_name, party, tenancy=tenancy_cfg
    )
    tenancy_context.activate(fed_ctx)
    tenancy_qos.get_scheduler().register(job_name, fed_ctx.tenancy)

    init_global_context(
        job_name=job_name,
        current_party=party,
        sending_failure_handler=sending_failure_handler,
        exit_on_sending_failure=cross_silo_comm_config.exit_on_sending_failure,
        continue_waiting_for_data_sending_on_error=(
            cross_silo_comm_config.continue_waiting_for_data_sending_on_error
        ),
        party_process_id=party_process_id,
        party_num_processes=party_num_processes,
    )

    if binds_device:
        fed_mesh.init_party_device(
            party_mesh_cfg, num_processes=party_num_processes,
            local_device_ids=local_device_ids)
    if jax_dist is not None:
        # The party's processes join their group (the JAX package's
        # jax.distributed join), on the job's receive deadline, and its
        # mesh spans the group's ranks.
        recv_ms = cross_silo_comm_config.recv_timeout_in_ms
        fed_mesh.init_distributed(
            jax_dist["coordinator_address"], party_num_processes,
            party_process_id, local_device_ids,
            device=fed_mesh.get_party_device(),
            timeout_s=recv_ms / 1000 if recv_ms else None)
        if party_num_processes > 1:
            fed_mesh.init_party_mesh(party_mesh_cfg)

    tls_config = {} if tls_config is None else tls_config
    if tls_config:
        assert (
            "cert" in tls_config and "key" in tls_config
        ), "Cert or key are not in tls_config."

    kv_store = config.get("kv_store")
    if kv_store is not None:
        # Shared (file-backed) KV so every process of a multi-process
        # party reads the same cluster/job config; only the leader clears
        # it on shutdown.
        internal_kv.kv_configure(
            backend=kv_store.get("backend", "memory"),
            path=kv_store.get("path"),
            clear_on_reset=party_process_id == 0,
        )
    internal_kv.kv_initialize(job_name)
    cluster_config = {
        constants.KEY_OF_CLUSTER_ADDRESSES: addresses,
        constants.KEY_OF_CURRENT_PARTY_NAME: party,
        constants.KEY_OF_TLS_CONFIG: tls_config,
    }
    internal_kv.kv_put(
        job_name, constants.KEY_OF_CLUSTER_CONFIG, pickle.dumps(cluster_config)
    )
    job_config = {
        constants.KEY_OF_CROSS_SILO_COMM_CONFIG_DICT: cross_silo_comm_dict,
    }
    internal_kv.kv_put(
        job_name, constants.KEY_OF_JOB_CONFIG, pickle.dumps(job_config)
    )

    setup_logger(
        logging_level=logging_level,
        logging_format=constants.LOG_FORMAT,
        party_val=party,
        job_name=job_name,
    )
    logger.info("Started rayfed_tpu_torch with %s", cluster_config)

    # Signal handlers can only be installed from the main thread; a
    # secondary job initialized from a worker thread (multi-tenant
    # process) simply shares the handler the first job installed.
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, _signal_handler)
    get_global_context().get_cleanup_manager().start(
        exit_on_sending_failure=cross_silo_comm_config.exit_on_sending_failure,
        expose_error_trace=cross_silo_comm_config.expose_error_trace,
    )

    use_global_proxy = cross_silo_comm_dict.get("use_global_proxy", True)
    if party_process_id != 0:
        # Follower process of a multi-process party: the leader owns the
        # wire (listen port, sends, receives); this process runs the
        # party's tasks and gets received values from the leader's relay.
        logger.info(
            "Joined party %s as follower process %d; proxies stay on the "
            "leader.", party, party_process_id,
        )
    elif receiver_sender_proxy_cls is not None:
        barriers.start_sender_receiver_proxy(
            addresses=addresses,
            party=party,
            job_name=job_name,
            tls_config=tls_config,
            proxy_cls=receiver_sender_proxy_cls,
            proxy_config=cross_silo_comm_dict,
            ready_timeout_s=cross_silo_comm_config.timeout_in_ms / 1000,
            use_global_proxy=use_global_proxy,
        )
    else:
        default_sender_cls, default_receiver_cls = (
            barriers._default_transport_classes(transport)
        )
        receiver_proxy_cls = receiver_proxy_cls or default_receiver_cls
        sender_proxy_cls = sender_proxy_cls or default_sender_cls

        barriers.start_receiver_proxy(
            addresses=addresses,
            party=party,
            job_name=job_name,
            tls_config=tls_config,
            proxy_cls=receiver_proxy_cls,
            proxy_config=cross_silo_comm_dict,
            ready_timeout_s=cross_silo_comm_config.timeout_in_ms / 1000,
            use_global_proxy=use_global_proxy,
        )
        barriers.start_sender_proxy(
            addresses=addresses,
            party=party,
            job_name=job_name,
            tls_config=tls_config,
            proxy_cls=sender_proxy_cls,
            proxy_config=cross_silo_comm_dict,
            use_global_proxy=use_global_proxy,
        )

    # Aggregation topology default (rayfed_tpu_torch/topology.py): every
    # driver reads the same config, so every party plans the identical
    # reduction DAG (multi-controller contract).
    if aggregation_dict:
        from rayfed_tpu_torch import topology as _topology

        _topology.set_default(
            aggregation_dict.get("topology", "auto"),
            group_size=aggregation_dict.get("group_size"),
        )
        # Async-mode job defaults (aggregation.async_* keys,
        # docs/async_rounds.md), validated above.
        _async_rounds.set_default_async_config(aggregation_dict)

    # Serving-plane job defaults (docs/serving.md): stored like the
    # aggregation topology default — every driver reads the same dict, so
    # a later fed.serve() builds the identical engine on every party.
    if serving_dict is not None:
        from rayfed_tpu_torch.serving import client as _serving_client

        _serving_client.set_default_serving_config(serving_dict)

    # Resilience wiring (docs/resilience.md). The fault injector wraps
    # the just-started sender proxy BEFORE the readiness barrier so a
    # schedule can exercise init-time faults too; the liveness monitor
    # starts last, its heartbeats riding the same (possibly injected)
    # sender, so a partitioned link takes the heartbeats down with the
    # data.
    resilience_dict = config.get("resilience") or {}
    if resilience_dict and party_process_id == 0:
        from rayfed_tpu_torch.resilience import inject as _inject
        from rayfed_tpu_torch.resilience import liveness as _liveness

        schedule_dict = resilience_dict.get("fault_schedule")
        if schedule_dict is not None:
            _inject.install(
                _inject.FaultSchedule.from_dict(schedule_dict), party
            )
        liveness_dict = resilience_dict.get("liveness")
        if liveness_dict is not None:
            monitor = _liveness.start_monitor(
                [p for p in addresses if p != party],
                _liveness.LivenessConfig.from_dict(liveness_dict),
            )
            # A DEAD peer never acks its shm descriptor frames, so its
            # in-flight ring chunks would leak until ring close: reclaim
            # them on the DEAD edge. Additive subscription (the
            # set_on_dead slot belongs to membership). The monitor's
            # thread never inherited this job's contextvar, so the
            # callback re-binds it explicitly.
            def _reclaim_dead_peer(*args, _ctx=fed_ctx, **kwargs):
                with tenancy_context.use_context(_ctx):
                    return barriers.cancel_peer_inflight(*args, **kwargs)

            monitor.add_on_dead(_reclaim_dead_peer)

    # Elastic membership (docs/membership.md): every founding party builds
    # the same epoch-0 view from the init addresses and installs the
    # manager's engine hooks (seq-id epoch stamp, rendezvous roster,
    # coordinator control handler + liveness DEAD escalation). AFTER the
    # resilience block — the coordinator's manager wires itself onto the
    # just-started monitor.
    if membership_cfg is not None and party_process_id == 0:
        from rayfed_tpu_torch.membership import (
            MembershipManager,
            MembershipView,
            set_membership_manager,
        )

        membership_manager = MembershipManager(
            job_name,
            party,
            MembershipView(
                epoch=0,
                roster=tuple(sorted(addresses)),
                addresses=dict(addresses),
            ),
            membership_cfg,
        )
        membership_manager.install()
        set_membership_manager(membership_manager)

    # Job-checkpoint defaults (docs/ha.md): already validated before any
    # state was built; installing them cannot fail at this point.
    if checkpoint_dict is not None:
        from rayfed_tpu_torch import checkpoint as _checkpoint

        _checkpoint.set_default_checkpoint_config(checkpoint_dict)

    # Privacy plane (docs/privacy.md): the manager owns the pairwise seed
    # store and the ``prv:`` control handler. AFTER membership (dropout
    # recovery consults the roster). Only the party's leader, which owns
    # the control handlers.
    if privacy_cfg is not None and party_process_id == 0:
        from rayfed_tpu_torch.privacy.manager import install_privacy

        install_privacy(job_name, party, privacy_cfg)

    # Telemetry plane (docs/observability.md): per-party metrics agent +
    # the collector/HTTP endpoint at the collector party. AFTER the
    # membership block so the collector's fleet view can consult the
    # installed manager from its first scrape.
    if telemetry_cfg is not None and party_process_id == 0:
        from rayfed_tpu_torch import telemetry as _telemetry

        _telemetry.start(job_name, party, dict(addresses), telemetry_cfg)

    if config.get("barrier_on_initializing", False) and party_process_id == 0:
        barriers.ping_others(addresses=addresses, self_party=party, max_retries=3600)


def shutdown():
    """Intended shutdown (ref api.py:299-306): wins the shutdown-once flag,
    drains pending sends, then tears the runtime down."""
    ctx = get_global_context()
    if ctx is not None and ctx.acquire_shutdown_flag():
        _shutdown(True)


def _shutdown(intended: bool = True):
    if get_global_context() is None:
        return
    # Bind the job being shut down to this thread for the whole teardown:
    # every plane's JobScoped lookups below must resolve THIS job even
    # when shutdown is called from a thread that never ran fed.init (or
    # while other jobs are live in the process).
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    fed_ctx = tenancy_context.get_context(
        get_global_context().get_job_name()
    )
    if fed_ctx is not None:
        with tenancy_context.use_context(fed_ctx):
            _shutdown_impl(intended)
    else:
        _shutdown_impl(intended)


def _shutdown_impl(intended: bool = True):
    if get_global_context() is None:
        return

    if intended:
        logger.info("Shutting down rayfed_tpu_torch intendedly...")
    else:
        logger.warning("Shutting down rayfed_tpu_torch unintendedly...")
    ctx = get_global_context()
    last_sending_error = ctx.get_cleanup_manager().get_last_sending_error()
    last_received_error = ctx.get_last_received_error()
    if last_sending_error is not None:
        logger.error("Cross-silo sending error occurred. %s", last_sending_error)

    wait_for_sending = True
    if (
        last_sending_error is not None or last_received_error is not None
    ) and not ctx.get_continue_waiting_for_data_sending_on_error():
        wait_for_sending = False
    logger.info(
        "%s for data sending.", "Wait" if wait_for_sending else "No wait"
    )

    exit_on_sending_failure = False
    if not intended:
        failure_handler = ctx.get_sending_failure_handler()
        if failure_handler is not None:
            logger.info("Executing failure handler %s ...", failure_handler)
            failure_handler(last_sending_error)
        exit_on_sending_failure = ctx.get_exit_on_sending_failure()

    # Telemetry stops first of all, while the proxies are still up: the
    # agent's final flush rides the inline lane, and the collector's
    # control handler unregisters before the rendezvous store goes away.
    # No-op when init never started it.
    _telemetry = sys.modules.get("rayfed_tpu_torch.telemetry")
    if _telemetry is not None:
        try:
            _telemetry.stop(flush=intended)
        except Exception:  # noqa: BLE001 - telemetry must not block teardown
            logger.warning("telemetry shutdown failed", exc_info=True)
    # Resilience teardown FIRST — before the send drain and long before
    # the proxies go away: a heartbeat tick landing mid-teardown would
    # count misses against peers that are merely shutting down too (and
    # log spurious SUSPECT verdicts), and uninstalling the injector
    # restores the real proxy so stop_proxies stops what init started.
    # The modules are always importable here (config.py pulls the package
    # in), and both calls are no-ops when init never enabled them.
    from rayfed_tpu_torch.resilience import inject as _inject
    from rayfed_tpu_torch.resilience import liveness as _liveness

    _liveness.stop_monitor()
    _inject.uninstall()
    # Membership hooks next (seq-id epoch stamp, rendezvous control
    # handler/roster): the drain below must run against the bare engine.
    # An in-flight coordinator takeover finishes (bounded) against live
    # proxies first — tearing the plane down mid-broadcast would strand
    # survivors parked on a sync that will never come (docs/ha.md).
    _membership = sys.modules.get("rayfed_tpu_torch.membership.manager")
    if _membership is not None:
        _mbr_mgr = _membership.get_membership_manager()
        if _mbr_mgr is not None:
            try:
                _mbr_mgr.drain_takeover(2.0)
            except Exception:  # noqa: BLE001 - must not block teardown
                logger.warning("membership drain failed", exc_info=True)
        _membership.clear_membership_manager()
    # Privacy plane: unregister the prv: control handler while the
    # rendezvous store is still up, and drop the seeds — a new job must
    # not aggregate under an old job's masks.
    _privacy = sys.modules.get("rayfed_tpu_torch.privacy.manager")
    if _privacy is not None:
        try:
            _privacy.uninstall_privacy()
        except Exception:  # noqa: BLE001 - must not block teardown
            logger.warning("privacy-plane teardown failed", exc_info=True)
    internal_kv.kv_reset()
    clear_global_context(wait_for_sending=wait_for_sending)
    # Async aggregation sessions hold buffered contribution trees; the
    # reset sweep below drops them (a new job must not fold into them),
    # after any mid-adopt aggregator handoff has finished (docs/ha.md).
    _async_rounds = sys.modules.get("rayfed_tpu_torch.async_rounds")
    if _async_rounds is not None:
        try:
            _async_rounds.drain_handoffs(2.0)
        except Exception:  # noqa: BLE001 - must not block teardown
            logger.warning("async handoff drain failed", exc_info=True)
    # Serving engines hold a live thread and the pool's device memory;
    # stop them before the proxies so a submit task in flight fails
    # loudly instead of wedging teardown.
    _serving_server = sys.modules.get("rayfed_tpu_torch.serving.server")
    if _serving_server is not None:
        _serving_server.stop_all_servers()
    _serving_client = sys.modules.get("rayfed_tpu_torch.serving.client")
    if _serving_client is not None:
        _serving_client.set_default_serving_config(None)
    barriers.stop_proxies(job_name=ctx.get_job_name())
    # A multi-process party's group outlives the job, as the JAX
    # package's jax.distributed group does: a later init reuses it
    # (mesh.shutdown_distributed destroys it).
    fed_config.reset_config_cache()
    # FedSanitizer probe state is per-job: a new job's seq ids start over,
    # so the monotonicity watermarks (and the other probe maps) must not
    # carry across or the first send of the next job trips spuriously.
    sanitize.reset()
    # Completeness sweep (docs/multitenancy.md): every reset hook in the
    # singleton-inventory table runs for this job — the ordered teardown
    # above covers the drains that need arguments; the sweep guarantees
    # no plane's per-job state survives, including planes init never
    # touched. GLOBAL-scope hooks (tracing buffers, shared listeners,
    # the QoS arbiter itself) only fire when this was the last live job.
    # Then the job leaves the scheduler and context registry.
    from rayfed_tpu_torch.tenancy import context as tenancy_context
    from rayfed_tpu_torch.tenancy import reset as tenancy_reset

    job = ctx.get_job_name()
    last = len(tenancy_context.contexts()) <= 1
    tenancy_reset.run_all_reset_hooks(job, last=last)
    tenancy_context.remove_context(job)
    logger.info("Shutdown rayfed_tpu_torch.")
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, original_sigint)
    if exit_on_sending_failure:
        logger.critical("Exit now due to the previous error.")
        sys.exit(1)


def _get_addresses(job_name: str) -> Dict[str, str]:
    cfg = fed_config.get_cluster_config(job_name)
    return cfg.cluster_addresses if cfg else {}


def _get_party(job_name: str) -> str:
    cfg = fed_config.get_cluster_config(job_name)
    return cfg.current_party if cfg else ""


def _get_tls(job_name: str) -> Dict:
    cfg = fed_config.get_cluster_config(job_name)
    return cfg.tls_config if cfg else {}


class FedRemoteFunction:
    """`@fed.remote` over a function (ref api.py:384-417)."""

    def __init__(self, func_or_class) -> None:
        self._node_party = None
        self._func_body = func_or_class
        self._options: Dict[str, Any] = {}
        self._fed_call_holder = None

    def party(self, party: str):
        self._node_party = party
        self._fed_call_holder = FedCallHolder(
            self._node_party, self._execute_impl, self._options
        )
        return self

    def options(self, **options):
        self._options = options
        if self._fed_call_holder:
            self._fed_call_holder.options(**options)
        return self

    def remote(self, *args, **kwargs):
        if not self._node_party:
            raise ValueError(
                "call .party(<name>) before .remote(): a fed task needs an "
                "executing party"
            )
        return self._fed_call_holder.internal_remote(*args, **kwargs)

    def _execute_impl(self, args, kwargs):
        return get_global_context().get_executor().submit(
            self._func_body,
            args,
            kwargs,
            num_returns=self._options.get("num_returns", 1),
            eager=self._options.get("eager", True),
        )


class FedRemoteClass:
    """`@fed.remote` over a class (ref api.py:433-448)."""

    def __init__(self, func_or_class) -> None:
        self._party = None
        self._cls = func_or_class
        self._options: Dict[str, Any] = {}

    def party(self, party: str):
        self._party = party
        return self

    def options(self, **options):
        self._options = options
        return self

    def remote(self, *cls_args, **cls_kwargs) -> FedActorHandle:
        fed_class_task_id = get_global_context().next_seq_id()
        job_name = get_global_context().get_job_name()
        fed_actor_handle = FedActorHandle(
            fed_class_task_id,
            _get_addresses(job_name),
            self._cls,
            _get_party(job_name),
            self._party,
            self._options,
        )
        fed_call_holder = FedCallHolder(
            self._party, fed_actor_handle._execute_impl, self._options
        )
        fed_call_holder.internal_remote(*cls_args, **cls_kwargs)
        return fed_actor_handle


def join(
    address: str,
    party: str,
    coordinator: str,
    coordinator_address: str,
    config: Optional[Dict] = None,
    tls_config: Optional[Dict] = None,
    logging_level: str = "info",
    job_name: Optional[str] = None,
    transport: Optional[str] = None,
    timeout: Optional[float] = None,
) -> Any:
    """Join a RUNNING membership-enabled job mid-training.

    Boots a minimal two-party runtime ({this party, the coordinator}),
    then runs the join handshake: authenticate with the coordinator
    (``config['membership']['auth_token']`` must match the job's), park
    on the JoinAccept the coordinator emits at its next
    ``fed.membership_sync()``, install the received view (full roster,
    addresses, ghost tables, sync index), re-key the seq-id space to the
    admitting epoch, and warm-dial every peer.

    Returns the bootstrap state the coordinator attached to the accept —
    ``{"kind": "provider"|"checkpoint"|"model_bank", ...}`` or None —
    which the driver uses to enter the training loop at the current
    round. The joiner already holds the view of the sync that admitted
    it, so its driver SKIPS the membership_sync of its entry round and
    resumes the per-round sync with everyone else from the next round on.

    Args:
        address: this party's listen address ("host:port").
        party: this party's name (must not collide with a roster member).
        coordinator: the coordinator party's name.
        coordinator_address: the coordinator's listen address.
        config: job config dict, as in :func:`init`. The
            ``membership`` sub-dict configures the handshake
            (``auth_token``, ``join_timeout_s``); ``barrier_on_initializing``
            is ignored (the handshake is the readiness barrier).
        timeout: handshake deadline in seconds; defaults to
            ``membership.join_timeout_s``.
    """
    from rayfed_tpu_torch.membership import MembershipConfig
    from rayfed_tpu_torch.membership import manager as _mbr_manager

    config = dict(config or {})
    membership_config = MembershipConfig.from_dict(
        config.pop("membership", None) or {}
    )
    if membership_config.coordinator is None:
        membership_config.coordinator = coordinator
    # The handshake below IS the readiness barrier (the request's ack
    # proves the coordinator is up); the ping barrier would deadlock on
    # roster members that are past init.
    config.pop("barrier_on_initializing", None)
    init(
        addresses={party: address, coordinator: coordinator_address},
        party=party,
        config=config,
        tls_config=tls_config,
        logging_level=logging_level,
        job_name=job_name,
        transport=transport,
    )
    job = get_global_context().get_job_name()
    _, bootstrap = _mbr_manager.join_handshake(
        job, party, address, coordinator, membership_config, timeout=timeout
    )
    return bootstrap


def leave(timeout: Optional[float] = None) -> None:
    """Gracefully depart a membership-enabled job: notify the coordinator
    (it removes this party from the roster at its next sync), then run
    the ordinary intended shutdown — which drains in-flight sends and
    releases this party's rendezvous entries with the proxies. Peers drop
    the departed party at the eviction bump instead of waiting out a
    liveness DEAD verdict."""
    from rayfed_tpu_torch.membership import manager as _mbr_manager

    manager = _mbr_manager.get_membership_manager()
    if manager is None:
        raise RuntimeError(
            "fed.leave() needs a membership-enabled job: pass "
            "config={'membership': {...}} to fed.init, or enter via "
            "fed.join"
        )
    manager.leave(timeout=timeout)
    shutdown()


def membership_sync(timeout: Optional[float] = None):
    """One membership sync point — call at the SAME program point (a
    round boundary) on every roster party. The coordinator folds pending
    joins/leaves/evictions into the next view and broadcasts it; everyone
    else receives and applies it. Returns the (possibly unchanged)
    :class:`~rayfed_tpu_torch.membership.MembershipView` now in force.
    Consumes no data seq ids."""
    from rayfed_tpu_torch.membership import manager as _mbr_manager

    manager = _mbr_manager.get_membership_manager()
    if manager is None:
        raise RuntimeError(
            "fed.membership_sync() needs a membership-enabled job: pass "
            "config={'membership': {...}} to fed.init, or enter via "
            "fed.join"
        )
    return manager.membership_sync(timeout=timeout)


def membership_view():
    """This party's current membership view, or None on membership-free
    jobs."""
    from rayfed_tpu_torch.membership import manager as _mbr_manager

    manager = _mbr_manager.get_membership_manager()
    return None if manager is None else manager.view()


def privacy_ledger() -> Dict[str, Dict[str, float]]:
    """The DP ledger THIS process has accumulated: ``{party:
    {"epsilon", "delta", "rounds"}}`` for every party charged by a noisy
    secure aggregation this session (docs/privacy.md). Epsilon accrues
    at the aggregation ROOT (where the noise is added); other parties see
    it through the ``fed_privacy_ledger_epsilon`` telemetry gauge. Empty
    when the privacy plane is off, ``noise_multiplier`` is unset, or no
    noisy round has folded yet."""
    from rayfed_tpu_torch.privacy.manager import get_privacy_manager

    manager = get_privacy_manager()
    return {} if manager is None else manager.ledger_snapshot()


def membership_stats() -> Dict[str, int]:
    """This party's membership HA counters (the ``get_stats()`` mirror
    of the ``fed_membership_*`` telemetry series, docs/ha.md): adopted
    ``term``, ``failovers`` (depositions adopted), ``takeovers`` (times
    THIS party won the election), ``stale_syncs_rejected``, plus —
    on the coordinator — the fold counters (``epoch_bumps``,
    ``joins_accepted``, ...). Empty on membership-free jobs."""
    from rayfed_tpu_torch.membership import manager as _mbr_manager

    manager = _mbr_manager.get_membership_manager()
    if manager is None:
        return {}
    out = manager.ha_stats()
    out["term"] = manager.term()
    coordinator = manager.get_coordinator_state()
    if coordinator is not None:
        out.update(coordinator.stats)
    return out


def remote(*args, **kwargs):
    """Define a fed task or fed actor (ref api.py:452-528).

    Usable bare (``@fed.remote``) or with options
    (``@fed.remote(num_returns=2)``).
    """

    def _make_fed_remote(function_or_class, **options):
        if inspect.isfunction(function_or_class) or fed_utils_is_cython(
            function_or_class
        ):
            return FedRemoteFunction(function_or_class).options(**options)
        if inspect.isclass(function_or_class):
            return FedRemoteClass(function_or_class).options(**options)
        raise TypeError(
            f"@fed.remote expects a function or class, got "
            f"{type(function_or_class).__name__}"
        )

    if len(args) == 1 and len(kwargs) == 0 and callable(args[0]):
        return _make_fed_remote(args[0])
    assert not args and kwargs, (
        "use @fed.remote bare or with keyword options only, e.g. "
        "@fed.remote(num_returns=2)"
    )
    return lambda fn_or_cls: _make_fed_remote(fn_or_cls, **kwargs)


def fed_utils_is_cython(obj) -> bool:
    """Cython callables are functions too (ref ``fed/utils.py:166-179``)."""
    def check(x):
        return (
            hasattr(x, "__func__")
            and "cython" in type(x.__func__).__name__.lower()
        ) or "cython" in type(x).__name__.lower()

    return check(obj)


def get(
    fed_objects: Union[FedObject, List[FedObject]],
    *,
    timeout: Optional[float] = None,
    on_missing: str = "raise",
    default: Any = None,
) -> Any:
    """Resolve FedObjects to real values; the owner broadcasts to every
    other party (ref api.py:531-608 — `get` is itself a DAG node with a
    fresh seq id so all parties address the same edges).

    Degraded-mode keywords (docs/resilience.md; all keyword-only so the
    reference-shaped positional call keeps meaning what it always did):

    - ``timeout``: wall-clock budget in seconds shared across ALL the
      requested objects (a round with several missing contributors costs
      one timeout, not one each). None = wait forever (legacy).
    - ``on_missing``: what a missing value — recv deadline expired,
      retries exhausted, injected fault — turns into. ``"raise"``
      (default) propagates the failure; ``"drop"`` removes missing
      entries from a list result (a single missing FedObject resolves
      to ``fed.MISSING``, there being no list to drop it from);
      ``"default"`` substitutes ``default`` (``fed.MISSING`` if left at
      None). A ``FedRemoteError`` envelope always re-raises regardless:
      the peer was alive and its task *failed*, which no aggregation
      should silently average over.
    - ``default``: the substitute under ``on_missing="default"``. None
      means the :data:`rayfed_tpu_torch.MISSING` sentinel, which
      ``ops.aggregate.elastic_weighted_mean`` skips natively.

    Multi-controller caveat: like every fed API, the SAME call (same
    keywords) must run on every party — a party that drops while another
    raises diverges the program.
    """
    from rayfed_tpu_torch.resilience.degraded import (
        MISSING,
        resolve_with_policy,
        validate_on_missing,
    )

    validate_on_missing(on_missing)
    if default is None:
        default = MISSING
    # get() is itself a node in the DAG: it burns one seq id so every
    # party addresses the broadcast edges identically.
    consumer_seq_id = get_global_context().next_seq_id()
    job_name = get_global_context().get_job_name()
    addresses = _get_addresses(job_name)
    current_party = _get_party(job_name)
    single = isinstance(fed_objects, FedObject)
    if single:
        fed_objects = [fed_objects]

    futures = []
    for fed_object in fed_objects:
        if fed_object.get_party() == current_party:
            fut = fed_object.get_value_future()
            assert fut is not None
            futures.append(fut)
            for party_name in addresses:
                if party_name == current_party:
                    continue
                if fed_object._was_sending_or_sent_to_party(party_name):
                    continue
                fed_object._mark_is_sending_to_party(party_name)
                barriers.send(
                    dest_party=party_name,
                    data=fut,
                    upstream_seq_id=fed_object.get_fed_task_id(),
                    downstream_seq_id=consumer_seq_id,
                )
        else:
            if fed_object.get_value_future() is not None:
                fut = fed_object.get_value_future()
            else:
                fut = barriers.recv(
                    current_party,
                    fed_object.get_party(),
                    fed_object.get_fed_task_id(),
                    consumer_seq_id,
                )
                fed_object._cache_value_future(fut)
            futures.append(fut)

    try:
        if timeout is None and on_missing == "raise":
            # Legacy fast path, bit-for-bit: block forever per future
            # (stealing a not-yet-started producer inline instead of
            # waiting for a pool worker to wake).
            values = [executor.result_stealing(f) for f in futures]
        else:
            values, missing = resolve_with_policy(
                futures, timeout, on_missing, default
            )
            if on_missing == "drop":
                gone = set(missing)
                values = [v for i, v in enumerate(values) if i not in gone]
        if single:
            # A dropped single object leaves nothing to index: it
            # resolves to the MISSING sentinel instead (the ergonomic
            # twin of on_missing="default" with the default default).
            return values[0] if values else MISSING
        return values
    except FedRemoteError as e:
        logger.warning(
            "A peer party's task failed; re-raising its error envelope: %s",
            e.cause,
        )
        if get_global_context() is not None:
            get_global_context().set_last_received_error(e)
        raise


def is_party_leader() -> bool:
    """True on the host that owns this party's wire (host 0 of a
    multi-host party; always True for single-process parties).

    Raises if the fed runtime is not initialized — silently answering
    True on every host before ``fed.init`` (or after shutdown) would send
    all hosts down leader-only code paths."""
    ctx = get_global_context()
    if ctx is None:
        raise RuntimeError(
            "is_party_leader() needs an initialized fed runtime "
            "(call fed.init() first)"
        )
    return ctx.is_party_leader()


def kill(actor: FedActorHandle, *, no_restart: bool = True):
    """Kill a fed actor in its party (ref api.py:611-623)."""
    job_name = get_global_context().get_job_name()
    current_party = _get_party(job_name)
    if actor._node_party == current_party:
        actor._kill()
