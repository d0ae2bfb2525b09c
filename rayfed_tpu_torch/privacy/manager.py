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

"""The per-process privacy-plane manager (port of
``rayfed_tpu/privacy/manager.py``).

One :class:`PrivacyManager` per party process (installed by ``fed.init``
when ``config["privacy"]`` is present, torn down by ``fed.shutdown``):

- owns the pairwise seed store and the ``prv:`` control handler
  (seed offers and dropout-recovery re-offers arrive here);
- masks outgoing contributions and unmasks-by-cancellation at the
  aggregation root (privacy/secagg.py does the ring math, on the
  device that holds the leaves);
- applies the DP layer (clip party-side, noise root-side, privacy/dp.py)
  and keeps the :class:`~rayfed_tpu_torch.privacy.dp.PrivacyLedger`;
- mirrors every bump into the process-global telemetry registry
  (``fed_privacy_*`` series) AND a local ``stats`` dict.
"""

# fedlint: disable-file=seq-divergence
# Secure-aggregation pairwise mask exchange is inherently
# role-split (party i sends to j and receives from k by name
# order), so fed traffic is gated on party identity on purpose.
# Seed exchange uses reserved prv: control keys outside the data
# DAG; FED002 targets drivers, not this plane.

from __future__ import annotations

import hashlib
import logging
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch._private.constants import CODE_FORBIDDEN, CODE_OK
from rayfed_tpu_torch.ops.aggregate import tree_divide, tree_scale
from rayfed_tpu_torch.privacy import dp, protocol, secagg
from rayfed_tpu_torch.privacy.config import PrivacyConfig
from rayfed_tpu_torch.privacy.quantize import ErrorFeedbackQuantizer
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

_reg = telemetry_metrics.get_registry()
_m_masks = _reg.counter(
    "fed_privacy_masks_exchanged_total",
    "Pairwise mask streams applied to outgoing secure contributions.",
)
_m_recoveries = _reg.counter(
    "fed_privacy_dropout_recoveries_total",
    "Orphaned-mask reconstructions applied to a pending secure sum.",
)
_m_epsilon = _reg.gauge(
    "fed_privacy_ledger_epsilon",
    "Cumulative DP epsilon charged to each party this session.",
    labels=("party",),
)
_m_qbytes = _reg.counter(
    "fed_privacy_quantized_bytes_saved_total",
    "Wire bytes saved by the int8 quantized payload tier vs the "
    "original leaf dtype.",
)


def record_quantized_bytes_saved(nbytes: int) -> None:
    """Bump the quantized-savings counter (called from the serialization
    wire tier; also mirrored into the manager stats when one is
    installed)."""
    _m_qbytes.inc(int(nbytes))
    mgr = get_privacy_manager()
    if mgr is not None:
        with mgr._lock:
            mgr.stats["quantized_bytes_saved"] += int(nbytes)


class PrivacyManager:
    """Privacy-plane state for one party in one job."""

    def __init__(
        self, job_name: str, party: str, config: PrivacyConfig
    ) -> None:
        self.job_name = job_name
        self.party = party
        self.config = config
        self.ledger = dp.PrivacyLedger(config.delta)
        self.quantizer = ErrorFeedbackQuantizer()
        self._lock = threading.Lock()
        self._pair_seeds: Dict[str, int] = {}
        self._seed_events: Dict[str, threading.Event] = {}
        #: dead party -> {survivor: re-offered pairwise seed}
        self._recovery: Dict[str, Dict[str, int]] = {}
        self.stats: Dict[str, int] = {
            "masks_exchanged": 0,
            "dropout_recoveries": 0,
            "quantized_bytes_saved": 0,
        }

    # -- seed store ---------------------------------------------------------

    def _generate_seed(self, partner: str) -> int:
        if self.config.mask_seed is not None:
            lo, hi = sorted((self.party, partner))
            digest = hashlib.sha256(
                f"{self.config.mask_seed}|{lo}|{hi}".encode()
            ).digest()
            return int.from_bytes(digest[:8], "big") >> 1
        return secrets.randbits(63)

    def _seed_event(self, partner: str) -> threading.Event:
        with self._lock:
            ev = self._seed_events.get(partner)
            if ev is None:
                ev = self._seed_events[partner] = threading.Event()
            return ev

    def store_seed(self, partner: str, seed: int) -> None:
        with self._lock:
            self._pair_seeds[partner] = int(seed)
            ev = self._seed_events.get(partner)
        if ev is not None:
            ev.set()
        else:
            self._seed_event(partner).set()

    def pair_seed(self, partner: str) -> Optional[int]:
        with self._lock:
            return self._pair_seeds.get(partner)

    def drop_pair(self, partner: str) -> None:
        """Forget a partner's seed (after eviction + recovery — a
        rejoining incarnation must re-key)."""
        with self._lock:
            self._pair_seeds.pop(partner, None)
            self._seed_events.pop(partner, None)

    def ensure_pairs(
        self, partners, timeout: Optional[float] = None
    ) -> None:
        """Complete the pairwise seed exchange with every partner: the
        lexicographically smaller party generates and SENDS over a
        ``prv:seed`` control frame; the larger waits for the frame."""
        from rayfed_tpu_torch.proxy import barriers

        timeout = timeout or self.config.handshake_timeout_s
        deadline = time.monotonic() + timeout
        waits: List[str] = []
        for partner in sorted(set(partners) - {self.party}):
            with self._lock:
                if partner in self._pair_seeds:
                    continue
            if self.party < partner:
                seed = self._generate_seed(partner)
                with self._lock:
                    self._pair_seeds[partner] = seed
                nonce = protocol.new_nonce()
                fut = barriers.send(
                    partner,
                    protocol.make_seed_offer(
                        self.party, partner, seed, nonce
                    ),
                    protocol.SEED_SEQ,
                    nonce,
                )
                # The ack carries the partner handler's verdict; a party
                # without a privacy plane refuses with a 403 here rather
                # than wedging the round later.
                fut.result(timeout=max(0.1, deadline - time.monotonic()))
            else:
                waits.append(partner)
        for partner in waits:
            ev = self._seed_event(partner)
            if not ev.wait(timeout=max(0.0, deadline - time.monotonic())):
                raise secagg.SecAggError(
                    f"party {self.party!r} timed out after {timeout}s "
                    f"waiting for the pairwise seed from {partner!r} "
                    "(prv:seed frame never arrived — is the privacy "
                    "plane enabled there?)"
                )

    # -- dropout recovery ---------------------------------------------------

    def store_recovery(
        self, dead: str, survivor: str, seed: int,
        round_index: Optional[int] = None,
    ) -> None:
        with self._lock:
            self._recovery.setdefault(dead, {})[survivor] = int(seed)
        # A pending secure fold may now be completable.
        try:
            from rayfed_tpu_torch import async_rounds

            async_rounds.poke_secure_sessions()
        except Exception:  # noqa: BLE001 - poking is best-effort
            logger.debug("secure-session poke failed", exc_info=True)

    def recovery_seeds(
        self, dead: str, survivors
    ) -> Optional[Dict[str, int]]:
        """The re-offered seeds covering every survivor's pair with
        ``dead`` — or None while any survivor's re-offer is outstanding.
        The root's own pairwise seed fills in automatically."""
        with self._lock:
            offered = dict(self._recovery.get(dead, {}))
            own = self._pair_seeds.get(dead)
        if own is not None:
            offered.setdefault(self.party, own)
        needed = set(survivors)
        if not needed <= set(offered):
            return None
        return {s: offered[s] for s in needed}

    def record_recovery(self, dead: str) -> None:
        with self._lock:
            self.stats["dropout_recoveries"] += 1
        _m_recoveries.inc()

    def reoffer_seeds(
        self, dead: str, root: str, round_index: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> None:
        """Survivor-side dropout recovery: re-offer this party's
        pairwise seed with ``dead`` to the aggregation ``root`` over a
        ``prv:recover`` frame (driven by the liveness view / membership
        eviction — call it when ``fed.liveness_view()`` marks a
        co-contributor DEAD or after its eviction sync applies)."""
        seed = self.pair_seed(dead)
        if seed is None:
            raise secagg.SecAggError(
                f"party {self.party!r} holds no pairwise seed with "
                f"{dead!r} to re-offer"
            )
        if root == self.party:
            self.store_recovery(dead, self.party, seed, round_index)
            return
        from rayfed_tpu_torch.proxy import barriers

        nonce = protocol.new_nonce()
        fut = barriers.send(
            root,
            protocol.make_recover_offer(
                self.party, dead, seed, nonce, round_index
            ),
            protocol.RECOVER_SEQ,
            nonce,
        )
        fut.result(
            timeout=timeout or self.config.handshake_timeout_s
        )

    # -- the prv: control handler -------------------------------------------

    def control_handler(self, header: Dict, value: Any):
        if not isinstance(value, dict):
            return CODE_FORBIDDEN, "malformed privacy frame"
        kind = value.get("kind")
        if kind == "seed-offer":
            sender = value.get("from")
            if value.get("to") not in (None, self.party):
                return CODE_FORBIDDEN, "seed offer addressed elsewhere"
            if not isinstance(sender, str):
                return CODE_FORBIDDEN, "seed offer without a sender"
            self.store_seed(sender, int(value["seed"]))
            return CODE_OK, "seed stored"
        if kind == "recover-offer":
            sender = value.get("from")
            dead = value.get("dead")
            if not isinstance(sender, str) or not isinstance(dead, str):
                return CODE_FORBIDDEN, "malformed recover offer"
            self.store_recovery(
                dead, sender, int(value["seed"]), value.get("round")
            )
            return CODE_OK, "recovery seed stored"
        return CODE_FORBIDDEN, f"unknown privacy frame kind {kind!r}"

    # -- masking (party side) -----------------------------------------------

    def mask_contribution(
        self,
        tree: Any,
        *,
        party: str,
        parties: List[str],
        domain: str,
        round_index: int,
        weight: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Clip (DP), premultiply (wmean), encode into the ring, and mask
        against every co-contributor, on the device of the tree's leaves.
        Returns
        the wire envelope the root's :meth:`secure_reduce` consumes (the
        JAX package's: its ``q`` leaves are uint32 words in JAX's leaf
        order)."""
        cfg = self.config
        if cfg.clip_norm is not None:
            tree = dp.clip_tree(tree, float(cfg.clip_norm))
        if weight is not None:
            # The identical premultiply op the plaintext wmean path runs
            # (federated._premul) — part of the bit contract.
            tree = tree_scale(tree, float(weight))
        self.ensure_pairs([p for p in parties if p != party])
        ring, dtypes, spec = secagg.encode_tree(
            tree, cfg.fixedpoint_bits, len(parties)
        )
        with self._lock:
            seeds = dict(self._pair_seeds)
        # Leaf by leaf, in place: each ring leaf is freed as its wire
        # words are made, so a party holds one copy of the tree's words.
        wire = []
        for idx in range(len(ring)):
            words, ring[idx] = ring[idx], None
            wire.append(secagg.to_wire(secagg.mask_leaf(
                words, idx, party, list(parties), seeds, domain,
                round_index, inplace=True)))
        n_masks = len(parties) - 1
        with self._lock:
            self.stats["masks_exchanged"] += n_masks
        _m_masks.inc(n_masks)
        return {
            "__secagg__": 1,
            "party": party,
            "parties": list(parties),
            "domain": domain,
            "round": int(round_index),
            "w": None if weight is None else float(weight),
            "fp": cfg.fixedpoint_bits,
            "dtypes": dtypes,
            "q": tree_util.tree_unflatten(wire, spec),
        }

    # -- unmask-by-cancellation (root side) ---------------------------------

    def secure_reduce(
        self,
        op: str,
        parties: List[str],
        domain: str,
        round_index: int,
        weights: Optional[Dict[str, float]],
        envelopes: Dict[str, Dict[str, Any]],
    ) -> Any:
        """Cancel the masks in the modular domain, decode, and apply the
        plaintext path's own scaling ops (see docs/privacy.md for why
        this is bitwise-equal to plaintext whenever both arithmetics are
        exact). ``envelopes`` may omit dead parties IF every survivor's
        recovery seed has been re-offered (``prv:recover``). The words
        are summed on the device of the first envelope's leaves (under
        ``transport="cuda"``, the party's card)."""
        present = [p for p in parties if p in envelopes]
        missing = [p for p in parties if p not in envelopes]
        if not present:
            raise secagg.SecAggError("no masked contributions to reduce")
        first = envelopes[present[0]]
        spec = secagg._leaves(first["q"])[1]
        dtypes = list(first["dtypes"])
        fp = int(first["fp"])
        flat_qs = [secagg._leaves(envelopes[p]["q"])[0] for p in present]
        # The host fold. (The JAX package lowers it to one collective when
        # a composed party mesh covers exactly these parties, ROADMAP
        # Queue 1 item 12b; modular addition gives the same words.)
        words = secagg.modular_sum_host(flat_qs)
        device = words[0].device if words else None
        for dead in missing:
            seeds = self.recovery_seeds(dead, present)
            if seeds is None:
                raise secagg.SecAggError(
                    f"party {dead!r} dropped mid-round and not every "
                    f"survivor has re-offered its pairwise seed yet "
                    "(prv:recover)"
                )
            correction = secagg.orphan_correction(
                dead, seeds, domain, round_index,
                [w.shape for w in words], device,
            )
            words = secagg.modular_sub(words, correction)
            self.record_recovery(dead)
        out = secagg.decode_sum(words, dtypes, spec, fp)
        if op == "mean":
            # The identical scale op the plaintext path runs
            # (federated._scale) — part of the bit contract.
            out = tree_divide(out, float(len(present)))
        elif op == "wmean":
            assert weights is not None
            total = float(weights[present[0]])
            for p in present[1:]:
                total = total + float(weights[p])
            out = tree_divide(out, total)
        elif op != "sum":
            raise ValueError(f"secure aggregation supports sum/mean/wmean, "
                             f"got {op!r}")
        return self.apply_dp(out, present, round_index, op=op)

    # -- DP (root side) -----------------------------------------------------

    def apply_dp(
        self, tree: Any, parties, round_index: int, op: str = "mean"
    ) -> Any:
        """Add the round's Gaussian noise at the root (stddev ``z *
        clip_norm / n`` for mean and wmean, ``z * clip_norm`` for sum)
        and charge every contributing party one round."""
        cfg = self.config
        z = cfg.noise_multiplier
        if not z:
            return tree
        sensitivity = float(cfg.clip_norm)
        if op in ("mean", "wmean"):
            sensitivity /= max(1, len(parties))
        noisy = dp.gaussian_noise_tree(
            tree, float(z) * sensitivity, cfg.noise_seed, round_index
        )
        self.ledger.record_round(parties, float(z))
        for p in parties:
            _m_epsilon.labels(party=p).set(self.ledger.epsilon(p))
        return noisy

    def ledger_snapshot(self) -> Dict[str, Dict[str, float]]:
        return self.ledger.snapshot()

    def ledger_restore(self, snapshot: Optional[Dict[str, Dict]]) -> None:
        """Reload a checkpointed ledger snapshot (job restore) and
        refresh the per-party epsilon gauges from it."""
        self.ledger.restore(snapshot)
        for p, rec in (snapshot or {}).items():
            _m_epsilon.labels(party=p).set(float(rec.get("epsilon", 0.0)))


# ---------------------------------------------------------------------------
# Process singleton + install/uninstall (fed.init / fed.shutdown)
# ---------------------------------------------------------------------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_managers: "JobScoped[PrivacyManager]" = JobScoped("privacy.manager")


def get_privacy_manager() -> Optional[PrivacyManager]:
    return _managers.peek()


def require_privacy_manager(what: str) -> PrivacyManager:
    mgr = get_privacy_manager()
    if mgr is None:
        raise RuntimeError(
            f"{what} needs the privacy plane: pass config={{'privacy': "
            f"{{'secure_aggregation': True}}}} to fed.init (docs/privacy.md)"
        )
    return mgr


def set_privacy_manager(mgr: Optional[PrivacyManager]) -> None:
    if mgr is None:
        _managers.pop()
    else:
        _managers.set(mgr)


def install_privacy(
    job_name: str, party: str, config: PrivacyConfig
) -> PrivacyManager:
    """Install the manager and register the ``prv:`` control prefix
    (called by ``fed.init`` when ``config['privacy']`` is present)."""
    from rayfed_tpu_torch.proxy import rendezvous

    mgr = PrivacyManager(job_name, party, config)
    rendezvous.register_control_prefix(
        job_name, protocol.PRIVACY_SEQ_PREFIX, mgr.control_handler
    )
    set_privacy_manager(mgr)
    return mgr


def uninstall_privacy() -> None:
    """Tear down (called by ``fed.shutdown``); idempotent."""
    from rayfed_tpu_torch.proxy import rendezvous

    mgr = get_privacy_manager()
    if mgr is None:
        return
    rendezvous.unregister_control_prefix(
        mgr.job_name, protocol.PRIVACY_SEQ_PREFIX
    )
    set_privacy_manager(None)
