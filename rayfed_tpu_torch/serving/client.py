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

"""``fed.serve()`` / ``fed.submit_request()`` — the federated client
surface of the serving plane (port of ``rayfed_tpu/serving/client.py``;
the engine a host builds runs on the party's card unless ``device``
says otherwise).

Two traffic classes on two lanes: a request is a handful of token ids and
its response a handful more — msgpack-clean and far under the small-
message threshold, so submits ride the inline fast lane; a publish
flows a whole param tree from the aggregate's owner to the serving party,
riding the bulk (and, when enabled, striped multi-stream) lane. Training
rounds and serving traffic therefore exercise both lanes concurrently.

Multi-controller contract: like every fed API, each call here must run
identically on EVERY party's driver (the remote tasks burn seq ids).
``fed.serve`` itself burns none — it only builds the engine on the
hosting party — but ``submit``/``publish``/``stats``/``shutdown`` are fed
tasks. Submit tasks are issued with ``eager=False``: they block inside
the engine until the response is ready, so they must not run inline on
the submitting driver's thread (the executor's eager-inline path would
serialize the very concurrency the batch exists to exploit).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rayfed_tpu_torch import api as fed
from rayfed_tpu_torch._private.global_context import get_global_context
from rayfed_tpu_torch.config import ServingConfig
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

_m_client_submits = telemetry_metrics.get_registry().counter(
    "fed_serving_client_submits_total",
    "Requests submitted through a ServeHandle, by serving party.",
    labels=("party",),
)


@fed.remote
def _serve_submit(name: str, prompt, opts: Dict[str, Any]):
    from rayfed_tpu_torch.serving.server import get_server

    return get_server(name).submit_and_wait(prompt, **opts)


@fed.remote
def _serve_submit_stream(
    name: str, prompt, opts: Dict[str, Any], stream_id: str, stream_to: str
):
    from rayfed_tpu_torch._private.global_context import get_global_context as _gc
    from rayfed_tpu_torch.serving import stream as stream_mod
    from rayfed_tpu_torch.serving.server import get_server

    srv = get_server(name)
    me = _gc().get_current_party()
    if stream_to == me:
        sink = stream_mod.register_local_stream(stream_id)
    else:
        sink = stream_mod.RemoteStreamSink(
            stream_to, stream_id, window=srv.scfg.stream_window
        )
    fut = srv.submit(prompt, stream=sink, **opts)
    return fut.result()


@fed.remote
def _serve_publish(name: str, params, draft_params=None):
    from rayfed_tpu_torch.serving.server import get_server

    return get_server(name).publish(params, draft_params=draft_params)


@fed.remote
def _serve_replicate(name: str, params, version, draft_params=None):
    """Standby-side publish mirror: adopt the primary's new version into
    the replica bank AT the primary's version number (restore_state
    keeps the numbering monotonic across a later promotion)."""
    from rayfed_tpu_torch.serving.server import get_standby

    spec = get_standby(name)
    if spec is None:
        return 0
    extras = {}
    if draft_params is not None:
        extras["draft_params"] = draft_params
    return spec["bank"].restore_state(
        {"version": int(version), "params": params, "extras": extras}
    )


@fed.remote
def _serve_promote(name: str):
    """Turn this party's standby replica into the live engine for
    ``name``: build an InferenceServer around the replicated bank state
    and register it. Queued/looping clients resubmit to the new host."""
    from rayfed_tpu_torch.config import ServingConfig as _SC
    from rayfed_tpu_torch.serving.server import (
        InferenceServer,
        pop_standby,
        register_server,
    )

    spec = pop_standby(name)
    if spec is None:
        raise RuntimeError(
            f"no standby replica named {name!r} on this party — it was "
            "not listed in fed.serve(standby=...)"
        )
    server = InferenceServer(
        spec["model_cfg"],
        _SC.from_dict(spec["config"]),
        params=None,
        draft_cfg=spec.get("draft_cfg"),
        cache_dtype=spec.get("cache_dtype"),
        name=name,
        device=spec.get("device"),
    )
    version = server.bank.restore_state(spec["bank"].export_state())
    register_server(server)
    return version


@fed.remote
def _serve_stats(name: str):
    from rayfed_tpu_torch.serving.server import get_server

    return get_server(name).stats()


@fed.remote
def _serve_stop(name: str):
    from rayfed_tpu_torch.serving.server import get_server, unregister_server

    get_server(name).stop()
    unregister_server(name)
    return True


class ServeHandle:
    """Every party's view of one named serving engine.

    The handle is symmetric: all parties hold one, all parties make the
    same calls; only the hosting party runs the engine. Results come back
    as FedObjects — ``fed.get`` them (the response broadcast is itself a
    DAG node, so every driver must reach it).
    """

    def __init__(self, party: str, name: str = "default", standby=()):
        self.party = party
        self.name = name
        self.standby = tuple(standby)
        self._stream_n = 0  # deterministic: same sequence on every driver

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        mode: str = "generate",
        n_beams: int = 4,
        stream_to: Optional[str] = None,
    ):
        """Enqueue one request at the serving party; returns a FedObject
        of the response dict. Issue many submits before getting any — the
        engine batches whatever is in flight at each token boundary.

        With ``stream_to=<party>`` the return is ``(FedObject,
        TokenStream)`` and tokens additionally stream to that party
        incrementally as the engine samples them; only the ``stream_to``
        party's driver may iterate the stream (every driver must still
        pass the SAME ``stream_to`` — the stream id burns like a seq id).
        """
        opts: Dict[str, Any] = {"seed": int(seed), "mode": mode}
        if max_new_tokens is not None:
            opts["max_new_tokens"] = int(max_new_tokens)
        if temperature is not None:
            opts["temperature"] = float(temperature)
        if mode == "beam":
            opts["n_beams"] = int(n_beams)
        prompt = [int(t) for t in prompt]
        _m_client_submits.labels(party=self.party).inc()
        if stream_to is None:
            return (
                _serve_submit.party(self.party)
                .options(eager=False)
                .remote(self.name, prompt, opts)
            )
        from rayfed_tpu_torch.serving.stream import TokenStream

        stream_id = f"{self.name}:{self._stream_n}"
        self._stream_n += 1
        resp = (
            _serve_submit_stream.party(self.party)
            .options(eager=False)
            .remote(self.name, prompt, opts, stream_id, stream_to)
        )
        return resp, TokenStream(self.party, stream_id)

    def publish(self, params, draft_params=None) -> FedObject:
        """Install ``params`` (a value or a FedObject — e.g. the result
        of ``fed_aggregate``) as the next served version; returns a
        FedObject of the version number. When the aggregate lives at
        another party this is exactly an owner-push of the param tree
        over the bulk lane. Standby parties (``fed.serve(standby=...)``)
        receive the same version into their replica banks."""
        version = _serve_publish.party(self.party).remote(
            self.name, params, draft_params
        )
        for sb in self.standby:
            _serve_replicate.party(sb).remote(
                self.name, params, version, draft_params
            )
        return version

    def promote(self, new_host: str) -> FedObject:
        """Fail the serving role over to ``new_host`` (which must have
        been a ``standby=`` party): its replica bank becomes the live
        engine at the primary's last replicated version. Every surviving
        driver must call this identically; the handle re-addresses
        itself, so queued submits can simply be re-issued."""
        version = _serve_promote.party(new_host).remote(self.name)
        self.party = new_host
        self.standby = tuple(s for s in self.standby if s != new_host)
        return version

    def stats(self) -> FedObject:
        return _serve_stats.party(self.party).remote(self.name)

    def shutdown(self) -> FedObject:
        """Stop the engine (active requests finish, queued ones fail)."""
        return _serve_stop.party(self.party).remote(self.name)


def serve(
    party: str,
    model_cfg=None,
    *,
    config: Optional[Dict[str, Any]] = None,
    params: Any = None,
    draft_cfg=None,
    cache_dtype=None,
    name: str = "default",
    standby=(),
    device=None,
) -> ServeHandle:
    """Start (on ``party``) and address (everywhere) a serving engine.

    Every party calls this with identical arguments; the engine spins up
    only on the hosting party. ``config`` overrides the job-level
    ``config['serving']`` dict from ``fed.init``. ``params`` seeds
    version 1; otherwise the first :meth:`ServeHandle.publish` does.

    ``standby`` parties hold a passive replica: every
    :meth:`ServeHandle.publish` mirrors the new version into their
    replica banks, and :meth:`ServeHandle.promote` turns one into the
    live engine after the host dies — at the last replicated version,
    with zero requests aborted by the swap itself (clients re-issue
    whatever the dead host never answered).

    ``device`` places the engine (or a standby's replica bank): None is
    the party's card, as ``fed.init`` bound it; ``"cpu"`` runs it on the
    CPU.

    Burns no seq ids — the handle is pure addressing; the engine build is
    party-local (``get_server`` resolves it inside remote tasks).
    """
    ctx = get_global_context()
    if ctx is None:
        raise RuntimeError(
            "rayfed_tpu_torch is not initialized; call fed.init() first."
        )
    me = ctx.get_current_party()
    merged = dict(get_default_serving_config() or {})
    merged.update(config or {})
    if me == party:
        if model_cfg is None:
            raise ValueError(
                "fed.serve on the hosting party needs model_cfg"
            )
        from rayfed_tpu_torch.serving.server import InferenceServer, register_server

        server = InferenceServer(
            model_cfg,
            ServingConfig.from_dict(merged),
            params=params,
            draft_cfg=draft_cfg,
            cache_dtype=cache_dtype,
            name=name,
            device=device,
        )
        register_server(server)
    elif me in standby:
        if model_cfg is None:
            raise ValueError(
                "fed.serve on a standby party needs model_cfg"
            )
        from rayfed_tpu_torch import mesh
        from rayfed_tpu_torch.serving.publish import ModelBank
        from rayfed_tpu_torch.serving.server import register_standby

        ServingConfig.from_dict(merged)  # fail here, not at promotion
        bank = ModelBank(mesh.party_device(device))
        if params is not None:
            bank.publish(params)
        register_standby(name, {
            "model_cfg": model_cfg,
            "config": merged,
            "draft_cfg": draft_cfg,
            "cache_dtype": cache_dtype,
            "device": device,
            "bank": bank,
        })
    return ServeHandle(party, name, standby=standby)


def submit_request(handle: ServeHandle, prompt, **opts) -> FedObject:
    """``fed.submit_request(handle, prompt, ...)`` — sugar for
    :meth:`ServeHandle.submit`."""
    return handle.submit(prompt, **opts)


# Job-level default config (config['serving'] from fed.init), following
# the topology.set_default pattern: every driver reads the same dict, so
# every party builds the same engine.
from rayfed_tpu_torch.tenancy.context import JobScoped

_default_serving_configs: JobScoped = JobScoped("serving.default_config")


def set_default_serving_config(d: Optional[Dict[str, Any]]) -> None:
    if d:
        _default_serving_configs.set(dict(d))
    else:
        _default_serving_configs.pop()


def get_default_serving_config() -> Optional[Dict[str, Any]]:
    return _default_serving_configs.peek()
