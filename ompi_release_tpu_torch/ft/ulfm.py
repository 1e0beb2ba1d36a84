"""ULFM-style fault-tolerance state — the process-local view of the
job epoch, the known-failed process set, and revoked communicators
(counterpart of ``ompi_release_tpu/ft/ulfm.py``).

The MPI User-Level Failure Mitigation model (MPIX_Comm_revoke /
_shrink / _agree / _failure_ack) hangs off two pieces of shared
state, and this module is both for the runtime:

- the **job epoch**: a monotone counter owned by the HNP coordinator,
  bumped every time the failure picture changes (a worker promoted to
  failed, a replacement respawned, a replacement rejoined). Workers
  learn bumps through ``TAG_PROC_FAILED`` notices pushed over the
  lifeline (:meth:`~..runtime.coordinator.WorkerAgent.start_ft_watcher`)
  and through ``TAG_FT`` queries/agreements.
- the **failed/restarted/rejoined sets** (process indices): the
  authoritative copy lives at the HNP; this module caches the last
  notice so hot-path waits (``runtime/wire.py`` reaps, ctl waits, the
  PML's wire receive, the C plan executor's slices) can consult it with
  one read per bounded slice instead of an RPC.

Revocation is comm-scoped poison: :meth:`Communicator.revoke` marks
the cid here and pushes ``TAG_FT_REVOKE`` frames to the comm's peer
processes, whose FT watchers call :func:`state`.``apply_revoke`` —
every bounded wire wait on that cid then raises ``ERR_REVOKED``
within one slice, queued progress-engine schedules on the cid are
completed in error without running, and the comm's frozen plans (its
CUDA graphs and their pool, its wire plans and C executors) are
dropped, so their memory comes back and a rebuild on the same cid
records afresh.

The cid arithmetic (:func:`ft_cid`, the tenant bands) lives with the
rest of the cid layout in ``utils/cids.py``; it is re-exported here,
where the JAX package keeps it. The tenant band math is the service
plane's (ROADMAP item 16b), ported because a tenant-scoped rebuild uses
it.

Listeners (:meth:`FtState.add_listener`) run after every change of the
picture: a notice (the document) and a revoke (``{"revoked": cid}``) —
the C plan executor raises its fault words from one.

With obs on, a failure, a revoke and a band revoke each land in the
span journal (layer ``ft``), so the doctor's incident timeline places
them between a stalled round and its recovery; the flight recorder's
``ft_state`` contributor dumps the failure picture.

No torch imports here: this module sits under the wire router's hot
path and must stay import-light.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Dict, List, Optional, Set

from .. import obs as _obs
from ..mca import pvar
from ..utils import output
from ..utils.cids import (  # noqa: F401  (re-exported: the JAX API)
    FT_CID_BASE, FT_CID_EPOCHS, FT_CID_LIMIT, FT_CID_SLOTS, MAX_TENANTS,
    TENANT_CID_BASE, TENANT_CID_SLOT, ft_cid, tenant_band, tenant_cid,
    tenant_of_cid,
)
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("ulfm")

#: failures learned by THIS process (first time a pidx appears in a
#: notice's failed set) — the "exactly one failure" witness of the
#: recovery job test
failures_detected = pvar.counter(
    "ft_failures_detected",
    "process failures learned from coordinator TAG_PROC_FAILED "
    "notices (counted once per failed process index)",
)
revokes = pvar.counter(
    "ft_revokes",
    "communicator revocations observed (local revoke() calls plus "
    "TAG_FT_REVOKE poison frames from peers)",
)


def failed_at_of(doc: Optional[dict]) -> Dict[int, int]:
    """THE parser for a failure document's ``failed_at`` wire map
    (JSON stringifies the pidx keys): pidx -> epoch its current
    failure episode began. Malformed entries are dropped — one
    place, one behavior, for every consumer (apply_notice, shrink,
    errmgr.recover)."""
    out: Dict[int, int] = {}
    for k, e in ((doc or {}).get("failed_at") or {}).items():
        try:
            out[int(k)] = int(e)
        except (TypeError, ValueError):
            continue
    return out


class FtState:
    """Process-local cache of the job's failure picture."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.epoch = 0
        self.failed: Set[int] = set()      # process indices
        self.restarted: Set[int] = set()   # respawn granted
        self.rejoined: Set[int] = set()    # replacement re-wired
        self._ever_failed: Set[int] = set()
        #: pidx -> epoch at which its CURRENT failure episode began.
        #: ULFM failures are permanent PER COMMUNICATOR: a comm
        #: created at epoch E0 treats a peer as dead forever once it
        #: failed at any epoch >= E0, even after a replacement with
        #: the same process index rejoins (the replacement is a NEW
        #: incarnation, visible only to comms built at later epochs —
        #: the rebuild path).
        self.failed_at: Dict[int, int] = {}
        self.revoked: Dict[int, int] = {}  # cid -> epoch at revoke
        #: (lo, hi) -> epoch: whole revoked cid BANDS (a tenant's
        #: eviction poisons its entire range, including cids not yet
        #: minted). Empty for every single-job process: one falsy-dict
        #: check on the hot path.
        self.revoked_bands: Dict[tuple, int] = {}
        self._listeners: List[Callable[[dict], None]] = []

    # -- notices (coordinator -> worker) -----------------------------------
    def apply_notice(self, doc: dict) -> None:
        """Fold one TAG_PROC_FAILED / TAG_FT document into the local
        view. Documents are authoritative snapshots (epoch + full
        sets); stale epochs are ignored so a reordered notice can
        never roll the picture backwards."""
        try:
            epoch = int(doc.get("epoch", 0))
            failed = set(int(p) for p in doc.get("failed", ()))
            restarted = set(int(p) for p in doc.get("restarted", ()))
            rejoined = set(int(p) for p in doc.get("rejoined", ()))
        except (TypeError, ValueError):
            return  # malformed notice: never poison the cache
        with self._lock:
            if epoch < self.epoch:
                return
            self.epoch = epoch
            new_failures = failed - self._ever_failed
            self._ever_failed |= failed
            for p in failed - self.failed:
                # a NEW failure episode for this pidx starts now
                self.failed_at[p] = epoch
            # the coordinator's authoritative episode record (carried
            # by TAG_FT replies and newer notices) overrides the
            # locally-derived first-seen epochs: a worker that missed
            # the promotion notice still learns WHEN each episode began
            for p, e in failed_at_of(doc).items():
                self._ever_failed.add(p)
                if e > self.failed_at.get(p, -1):
                    self.failed_at[p] = e
            self.failed = failed
            self.restarted = restarted
            self.rejoined = rejoined
        for _ in new_failures:
            failures_detected.add()
        if new_failures:
            _log.verbose(1, f"epoch {epoch}: process(es) "
                            f"{sorted(new_failures)} failed")
            if _obs.enabled:
                # the failure event lands in the span journal so the
                # doctor's merged timeline shows WHEN each rank
                # learned of the death relative to its stalled round
                for p in sorted(new_failures):
                    _obs.record("ft_failure", "ft",
                                _time.perf_counter(), 0.0,
                                peer=int(p), comm_id=epoch)
        self._notify(doc)

    def add_listener(self, cb: Callable[[dict], None]) -> None:
        self._listeners.append(cb)

    def _notify(self, doc: dict) -> None:
        for cb in list(self._listeners):
            try:
                cb(doc)
            except Exception as e:  # a listener must not kill the watcher
                _log.verbose(1, f"ft listener failed: {e}")

    # -- revocation --------------------------------------------------------
    def apply_revoke(self, cid: int, epoch: int = -1) -> bool:
        """Mark ``cid`` revoked (idempotent). Returns True when this
        call was the first to poison the cid. Also completes queued
        progress-engine schedules on the cid in error and drops the
        comm's frozen plans — the revoke must interrupt pending ops,
        not only future ones."""
        with self._lock:
            first = cid not in self.revoked
            if first:
                self.revoked[cid] = (epoch if epoch >= 0 else self.epoch)
        if not first:
            return False
        revokes.add()
        _log.verbose(1, f"cid {cid} revoked")
        if _obs.enabled:
            # the revoke lands in the span journal (epoch in the peer
            # slot) so tpu-doctor report's incident timeline can place
            # it between the failure and the recovery
            _obs.record("ft_revoke", "ft", _time.perf_counter(), 0.0,
                        peer=(epoch if epoch >= 0 else self.epoch),
                        comm_id=cid)
        # a running C plan fire on the cid stops at its next slice
        self._notify({"revoked": int(cid)})
        # queued (not yet running) schedules on the revoked comm
        # complete in error without running: their wire exchanges
        # would only park peers on a poisoned channel
        try:
            from ..runtime import progress as _progress

            _progress.engine().fail_queued(
                ("comm", cid),
                lambda: MPIError(
                    ErrorCode.ERR_REVOKED,
                    f"communicator cid {cid} was revoked with this "
                    "schedule still queued",
                ),
            )
        except Exception as e:
            _log.verbose(1, f"revoke: queued-schedule sweep failed: {e}")
        # mirror onto the live comm object for the cheap
        # _check_usable() flag test on every op entry, and drop its
        # frozen plans (graphs, wire plans, C executors)
        try:
            from ..comm.communicator import _comm_registry

            c = _comm_registry.get(cid)
            if c is not None:
                c._revoked = True
                c._drop_plans()
        except Exception as e:
            _log.verbose(1, f"revoke: plan drop failed: {e}")
        return True

    def is_revoked(self, cid: int) -> bool:
        return (cid in self.revoked
                or (bool(self.revoked_bands)
                    and self._band_of(cid) is not None))

    def _band_of(self, cid: int):
        for band in self.revoked_bands:
            if band[0] <= cid < band[1]:
                return band
        return None

    # -- tenant-band revocation (service plane) ----------------------------
    def revoke_band(self, lo: int, hi: int, epoch: int = -1) -> int:
        """Poison every cid in ``[lo, hi)``: live communicators in the
        band are revoked through :meth:`apply_revoke`, and the band
        itself is recorded so any FUTURE cid minted in the range fails
        typed at its first bounded wait. Returns the number of LIVE
        communicators revoked. Idempotent."""
        with self._lock:
            first = (lo, hi) not in self.revoked_bands
            if first:
                self.revoked_bands[(lo, hi)] = (
                    epoch if epoch >= 0 else self.epoch)
        try:
            from ..comm.communicator import _comm_registry

            live = [c for c in list(_comm_registry) if lo <= c < hi]
        except Exception:
            live = []
        n = sum(1 for cid in live if self.apply_revoke(cid, epoch))
        if first:
            _log.verbose(1, f"cid band [{lo}, {hi}) revoked "
                            f"({n} live comm(s))")
            if _obs.enabled:
                # one band-level incident event (per-cid revokes
                # journal themselves through apply_revoke)
                _obs.record("ft_revoke_band", "ft",
                            _time.perf_counter(), 0.0,
                            peer=(epoch if epoch >= 0 else self.epoch),
                            comm_id=lo, nbytes=hi - lo)
        return n

    def clear_band(self, lo: int, hi: int) -> None:
        """Forget a band's revocation record plus every per-cid record
        inside it (a freed tenant id re-admitted later must start with
        a clean namespace)."""
        with self._lock:
            self.revoked_bands.pop((lo, hi), None)
            for cid in [c for c in self.revoked if lo <= c < hi]:
                self.revoked.pop(cid, None)

    def clear_revoked(self, cid: int) -> None:
        """Forget a cid's revocation record — the rebuild path's
        epoch-wrapped slot reuse: the record belonged to the evicted
        ancestor, and keeping it would poison the fresh comm minted
        at the same cid."""
        with self._lock:
            self.revoked.pop(cid, None)

    # -- hot-path checks (wire waits) --------------------------------------
    def dead_for(self, peers, epoch0: int = 0) -> List[int]:
        """The subset of ``peers`` dead for a communicator created at
        ``epoch0``: currently failed, or failed at ANY epoch since the
        comm existed (permanence — a same-pidx replacement is a new
        incarnation only comms built at later epochs may talk to)."""
        if not self.failed and not self.failed_at:
            return []
        return sorted(
            p for p in peers
            if p in self.failed or self.failed_at.get(p, -1) >= epoch0)

    def check_wait(self, cid: int, peers, what: str = "wait",
                   epoch0: int = 0) -> None:
        """Raise if ``cid`` is revoked or any process in ``peers`` is
        dead for a comm created at ``epoch0`` — the bounded-slice
        check that turns a would-be indefinite hang on a dead peer
        into ERR_PROC_FAILED within one detection interval."""
        if cid in self.revoked:
            raise MPIError(
                ErrorCode.ERR_REVOKED,
                f"{what} interrupted: communicator cid {cid} revoked",
            )
        if self.revoked_bands and self._band_of(cid) is not None:
            raise MPIError(
                ErrorCode.ERR_REVOKED,
                f"{what} interrupted: cid {cid} falls in a revoked "
                f"tenant band (tenant {tenant_of_cid(cid)} evicted)",
            )
        dead = self.dead_for(peers, epoch0)
        if dead:
            raise MPIError(
                ErrorCode.ERR_PROC_FAILED,
                f"{what} on process(es) {dead} which the job epoch "
                f"({self.epoch}) marks failed (comm epoch {epoch0})",
            )

    def check_peer(self, pidx: int, what: str = "send",
                   epoch0: int = 0) -> None:
        if self.dead_for((pidx,), epoch0):
            raise MPIError(
                ErrorCode.ERR_PROC_FAILED,
                f"{what} to process {pidx} which the job epoch "
                f"({self.epoch}) marks failed (comm epoch {epoch0})",
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "failed": sorted(self.failed),
                "restarted": sorted(self.restarted),
                "rejoined": sorted(self.rejoined),
                "revoked_cids": sorted(self.revoked),
                "revoked_bands": sorted(list(b)
                                        for b in self.revoked_bands),
                "failed_at": dict(self.failed_at),
            }

    def reset(self) -> None:
        """Test hook: wipe the process-local picture (listeners that
        modules registered at import stay)."""
        with self._lock:
            self.epoch = 0
            self.failed.clear()
            self.restarted.clear()
            self.rejoined.clear()
            self._ever_failed.clear()
            self.failed_at.clear()
            self.revoked.clear()
            self.revoked_bands.clear()


#: THE process-local FT state (the failure picture is per controller
#: process, like opal's process-global error manager)
STATE = FtState()


def state() -> FtState:
    return STATE


# postmortems must name known-failed ranks rather than listing them as
# merely "awaiting": the flight recorder gets the whole picture
from ..obs import watchdog as _watchdog  # noqa: E402

_watchdog.add_contributor("ft_state", lambda: STATE.snapshot())
