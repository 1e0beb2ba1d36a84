"""Tenant registry — admission control, leases, and scoped eviction.

The resident daemon (:mod:`.daemon`) admits many independently
launched jobs onto one fabric; this module is the bookkeeping that
makes them *tenants* instead of noisy neighbors:

- **admission control**: capacity in ranks and lanes, a bounded
  tenant-id space (the cid-band discipline of
  :mod:`..ft.ulfm` — 64 slots of 4096 cids each), duplicate-name
  refusal. Denials are typed errors, counted in
  ``service_admissions_denied``.
- **leases + heartbeats**: every tenant holds a lease (a secret
  token, an expiry) renewed by heartbeat; :meth:`TenantRegistry
  .sweep` evicts expired tenants — the daemon's serve loop runs it
  every iteration, so a tenant whose job died silently is gone within
  one lease, its published names pruned and its cid band revoked.
- **scoped eviction**: eviction revokes exactly the tenant's cid band
  through the real ULFM machinery (:meth:`~..ft.ulfm.FtState
  .revoke_band`), clears its sentinel chains, and notifies listeners
  (the daemon evicts the tenant's pubsub names by owner). Other
  tenants and the daemon never notice. A freed tenant slot is
  re-admittable: admission clears the stale band/chain state exactly
  like the explicit-cid rebuild path.

Import-light by design (no jax): the registry runs inside the daemon
process, inside tests, and inside the fleet simulator.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .. import obs as _obs
from ..ft import ulfm as _ulfm
from ..mca import pvar as _pvar
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("tenant")

DEFAULT_LEASE_S = 30.0
#: evicted-tenant records kept for the TAG_TENANTS forensics view
EVICTED_KEEP = 32

_admitted = _pvar.counter(
    "service_tenants_admitted",
    "tenants admitted to this service daemon's fabric",
)
_evicted = _pvar.counter(
    "service_tenants_evicted",
    "tenants evicted (released, failed, or lease-expired)",
)
_denied = _pvar.counter(
    "service_admissions_denied",
    "tenant admissions refused by capacity/identity admission control",
)


class Tenant:
    """One admitted tenant: identity, lease, capacity grant, QoS
    class, and the stats document its heartbeats report."""

    __slots__ = ("tid", "name", "owner", "qos", "ranks", "lanes",
                 "lease_s", "token", "admitted_at", "last_beat",
                 "expires_at", "state", "evict_reason", "stats")

    def __init__(self, tid: int, name: str, owner: Any, qos: str,
                 ranks: int, lanes: int, lease_s: float) -> None:
        now = time.monotonic()
        self.tid = tid
        self.name = name
        self.owner = owner
        self.qos = qos
        self.ranks = int(ranks)
        self.lanes = int(lanes)
        self.lease_s = float(lease_s)
        self.token = secrets.token_hex(8)
        self.admitted_at = now
        self.last_beat = now
        self.expires_at = now + self.lease_s
        self.state = "live"
        self.evict_reason: Optional[str] = None
        self.stats: Dict[str, Any] = {}

    @property
    def band(self) -> tuple:
        return _ulfm.tenant_band(self.tid)

    def doc(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-able record (no token: the lease secret never rides
        the TAG_TENANTS listing)."""
        now = time.monotonic() if now is None else now
        lo, hi = self.band
        return {
            "tid": self.tid, "name": self.name, "qos": self.qos,
            "ranks": self.ranks, "lanes": self.lanes,
            "state": self.state, "evict_reason": self.evict_reason,
            "band": [lo, hi], "lease_s": self.lease_s,
            "age_s": round(now - self.admitted_at, 3),
            "beat_age_s": round(now - self.last_beat, 3),
            "expires_in_s": round(self.expires_at - now, 3),
            "stats": dict(self.stats),
        }


class TenantRegistry:
    """Admission control + leases over the tenant cid-band space."""

    def __init__(self, *, capacity_ranks: int = 256,
                 capacity_lanes: int = 64,
                 lease_s: float = DEFAULT_LEASE_S,
                 max_tenants: int = _ulfm.MAX_TENANTS) -> None:
        self.capacity_ranks = int(capacity_ranks)
        self.capacity_lanes = int(capacity_lanes)
        self.lease_s = float(lease_s)
        self._lock = threading.Lock()
        self._tenants: Dict[int, Tenant] = {}
        self._free_tids: List[int] = list(
            range(min(int(max_tenants), _ulfm.MAX_TENANTS)))
        self._evicted: deque = deque(maxlen=EVICTED_KEEP)
        self._listeners: List[Callable[[Tenant, str], None]] = []

    # -- wiring ------------------------------------------------------------
    def add_evict_listener(
            self, cb: Callable[[Tenant, str], None]) -> None:
        """``cb(tenant, reason)`` runs on every eviction (the daemon
        registers pubsub name pruning here). A raising listener never
        blocks the eviction."""
        self._listeners.append(cb)

    # -- queries -----------------------------------------------------------
    def live(self) -> List[Tenant]:
        with self._lock:
            return sorted(self._tenants.values(), key=lambda t: t.tid)

    def get(self, tid: int) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.get(int(tid))

    def used_ranks(self) -> int:
        with self._lock:
            return sum(t.ranks for t in self._tenants.values())

    def used_lanes(self) -> int:
        with self._lock:
            return sum(t.lanes for t in self._tenants.values())

    def doc(self) -> Dict[str, Any]:
        """The TAG_TENANTS listing: live tenants, recent evictions,
        capacity."""
        now = time.monotonic()
        with self._lock:
            live = [t.doc(now) for t in
                    sorted(self._tenants.values(), key=lambda t: t.tid)]
            gone = [t.doc(now) for t in self._evicted]
            used_r = sum(t.ranks for t in self._tenants.values())
            used_l = sum(t.lanes for t in self._tenants.values())
        return {
            "tenants": live, "evicted": gone,
            "capacity": {"ranks": self.capacity_ranks,
                         "lanes": self.capacity_lanes,
                         "used_ranks": used_r, "used_lanes": used_l},
        }

    # -- admission ---------------------------------------------------------
    def admit(self, name: str, ranks: int, *, qos: str = "best_effort",
              lanes: int = 1, owner: Any = None,
              lease_s: Optional[float] = None) -> Tenant:
        """Admit one tenant or raise typed: ERR_ARG on a malformed
        request, ERR_NAME on a duplicate live name, ERR_NO_MEM when
        rank/lane capacity or the tenant-id space is exhausted."""
        name = str(name or "").strip()
        ranks = int(ranks)
        lanes = int(lanes)
        if not name or ranks <= 0 or lanes <= 0:
            _denied.add()
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"admission needs a name and positive ranks/lanes "
                f"(got name={name!r}, ranks={ranks}, lanes={lanes})",
            )
        with self._lock:
            if any(t.name == name for t in self._tenants.values()):
                _denied.add()
                raise MPIError(
                    ErrorCode.ERR_NAME,
                    f"tenant name '{name}' already admitted — release "
                    "it or pick another identity",
                )
            used_r = sum(t.ranks for t in self._tenants.values())
            used_l = sum(t.lanes for t in self._tenants.values())
            if used_r + ranks > self.capacity_ranks \
                    or used_l + lanes > self.capacity_lanes:
                _denied.add()
                raise MPIError(
                    ErrorCode.ERR_NO_MEM,
                    f"admission of '{name}' ({ranks} ranks, {lanes} "
                    f"lanes) exceeds capacity "
                    f"({used_r}/{self.capacity_ranks} ranks, "
                    f"{used_l}/{self.capacity_lanes} lanes in use)",
                )
            if not self._free_tids:
                _denied.add()
                raise MPIError(
                    ErrorCode.ERR_NO_MEM,
                    f"admission of '{name}': tenant-id space exhausted "
                    f"({_ulfm.MAX_TENANTS} slots)",
                )
            tid = self._free_tids.pop(0)
            t = Tenant(tid, name, owner, str(qos), ranks, lanes,
                       float(lease_s if lease_s is not None
                             else self.lease_s))
            self._tenants[tid] = t
        # a reused slot starts with a clean namespace: clear the
        # evicted predecessor's band poison + sentinel chains (the
        # explicit-cid rebuild discipline, band-wide)
        lo, hi = t.band
        _ulfm.state().clear_band(lo, hi)
        from ..obs import sentinel as _sentinel

        _sentinel.clear_band(lo, hi)
        _admitted.add()
        if _obs.enabled:
            # incident-timeline food: who joined the fabric, when,
            # with which band (comm slot) and capacity (bytes slot)
            _obs.record(f"tenant_admit:{name}", "service",
                        time.perf_counter(), 0.0, peer=tid,
                        comm_id=lo, nbytes=ranks)
        _log.verbose(1, f"admitted tenant {tid} '{name}' qos={qos} "
                        f"ranks={ranks} lanes={lanes} band=[{lo},{hi})")
        return t

    # -- leases ------------------------------------------------------------
    def _auth(self, tid: int, token: str) -> Tenant:
        t = self._tenants.get(int(tid))
        if t is None:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"unknown/evicted tenant id {tid}")
        if str(token) != t.token:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"bad lease token for tenant {tid} — another tenant "
                "cannot renew or release this lease",
            )
        return t

    def renew(self, tid: int, token: str,
              stats: Optional[Dict[str, Any]] = None) -> Tenant:
        """Heartbeat: extend the lease, fold the tenant's reported
        stats (coll/s, MB/s, lane share, HOL wait — whatever the job
        measures about itself) into the TAG_TENANTS view."""
        with self._lock:
            t = self._auth(tid, token)
            now = time.monotonic()
            t.last_beat = now
            t.expires_at = now + t.lease_s
            if stats:
                t.stats.update(
                    {str(k): v for k, v in stats.items()})
            return t

    def release(self, tid: int, token: str) -> Tenant:
        """Graceful exit: authenticated self-eviction."""
        with self._lock:
            t = self._auth(tid, token)
        return self._do_evict(t, "released")

    def fail(self, tid: int, token: str,
             reason: str = "rank failure reported") -> Tenant:
        """A tenant reporting its own rank death (the ULFM episode):
        eviction with the failure named — the band revoke is the
        'only that tenant's comms' guarantee."""
        with self._lock:
            t = self._auth(tid, token)
        return self._do_evict(t, reason)

    def evict(self, tid: int, reason: str) -> Optional[Tenant]:
        """Registry-side eviction (no token: the daemon operator and
        the sweep own this path)."""
        with self._lock:
            t = self._tenants.get(int(tid))
        if t is None:
            return None
        return self._do_evict(t, reason)

    def _do_evict(self, t: Tenant, reason: str) -> Tenant:
        with self._lock:
            if self._tenants.get(t.tid) is not t:
                return t  # already evicted (idempotent)
            del self._tenants[t.tid]
            t.state = "evicted"
            t.evict_reason = reason
            self._evicted.append(t)
            self._free_tids.append(t.tid)
            self._free_tids.sort()
        # the scoped revoke: exactly this tenant's cid band — live
        # comms poisoned through the real ULFM path, the band record
        # covering any future cid a straggler mints
        lo, hi = t.band
        _ulfm.state().revoke_band(lo, hi)
        from ..obs import sentinel as _sentinel

        _sentinel.clear_band(lo, hi)
        if _obs.enabled:
            _obs.record(f"tenant_evict:{t.name}:{reason}", "service",
                        time.perf_counter(), 0.0, peer=t.tid,
                        comm_id=lo, nbytes=t.ranks)
        for cb in list(self._listeners):
            try:
                cb(t, reason)
            except Exception as e:
                _log.verbose(1, f"evict listener failed: {e}")
        _evicted.add()
        _log.verbose(1, f"evicted tenant {t.tid} '{t.name}': {reason}")
        return t

    def sweep(self, now: Optional[float] = None) -> List[Tenant]:
        """Evict every live tenant whose lease expired (the daemon's
        serve loop runs this each iteration — lease expiry IS the
        lifeline-loss detector for silently dead jobs)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [t for t in self._tenants.values()
                       if t.expires_at <= now]
        return [self._do_evict(
            t, f"lease expired (no heartbeat for "
               f"{now - t.last_beat:.1f}s)") for t in expired]

    def note_owner_lost(self, owner: Any) -> List[Tenant]:
        """Lifeline loss: evict every live tenant admitted by
        ``owner`` (the daemon calls this when a client connection is
        known dead ahead of its lease expiry)."""
        with self._lock:
            lost = [t for t in self._tenants.values()
                    if t.owner == owner]
        return [self._do_evict(t, "owner lifeline lost")
                for t in lost]
