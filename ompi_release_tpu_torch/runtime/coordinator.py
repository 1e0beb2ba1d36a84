"""Multi-process coordinator over the native OOB — the HNP/orted wire-up
(counterpart of ``ompi_release_tpu/runtime/coordinator.py``).

The reference's launch wire-up (SURVEY §3.2): daemons report to the
HNP, the modex allgathers every proc's business card through the
daemon tree, and a runtime barrier gates MPI_Init completion. Here the
HNP is the job coordinator process (the ``tpurun`` launcher or rank 0)
and each worker process runs a WorkerAgent; messages are DSS-packed
frames over the native tree-routable OOB (``native/oob.cc``).

Topology: joins/barriers/heartbeats flow directly worker->HNP (every
worker holds an HNP link — the lifeline, ``errmgr_default_orted.c:252``),
while **xcast descends a binomial tree** (``grpcomm_bad_module.c:99``
through ``routed/binomial``): the HNP sends only to its tree children;
each worker, on receiving an xcast frame, forwards it to its own
children before delivering locally. Tree links are worker-to-worker
OOB connections established from the modex cards (each card carries
the worker's OOB listen port).

Failure detection mirrors ``sensor_heartbeat.c:61,78``: workers beat
periodically; the HNP-side monitor marks a worker failed after
``miss_limit`` silent intervals and invokes the registered callback
(the errmgr hook).

The ULFM plane rides the same endpoints: the HNP bumps the job epoch
and pushes a ``TAG_PROC_FAILED`` notice to every live worker whenever
the failure picture changes (a promotion, a respawn grant, a rejoin),
answers ``TAG_FT`` state queries and parks fault-tolerant agreements
until every live participant contributed; workers push
``TAG_FT_REVOKE`` poison frames to each other. The rejoin service
re-runs the wire-up for a respawned worker, and the migrate responder
serves ``tpu-migrate``. The observability plane rides them too: the
ps responder (tag 13) answers ``tpu_ps``, the clock responder (tag 16)
the workers' ping-pong offset estimate, and the series responder (tag
17) keeps the workers' sampler pushes in a bounded fleet store.

Tags mirror the RML usage pattern (``rml.h:318`` tagged send/recv).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..native import DssBuffer, OobEndpoint
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("coord")

TAG_JOIN = 1
TAG_MODEX = 2
TAG_BARRIER_ENTER = 3
TAG_BARRIER_RELEASE = 4
TAG_XCAST = 5
TAG_FIN = 6
TAG_HEARTBEAT = 7
TAG_XCAST_ORPHAN = 8  # worker->HNP: deliver xcast to unreachable child
TAG_PS = 13           # ps/top client->HNP: live job snapshot query
TAG_MIGRATE = 14      # migrate client->HNP: move ranks off a host
TAG_DIE = 15          # HNP->worker: exit immediately (odls kill)
TAG_CLOCK = 16        # worker->HNP ping-pong: clock-offset estimation
TAG_SERIES = 17       # worker->HNP: pvar time-series delta push;
#                       client->HNP: fleet series query (empty frame)
#                       (9-12 are the pubsub name-service tags)
TAG_PROC_FAILED = 18  # HNP->worker: job-epoch failure notice (ULFM
#                       detection plane: epoch + failed/restarted/
#                       rejoined process-index sets, JSON)
TAG_FT = 19           # worker->HNP RPC: failure-state query + the
#                       fault-tolerant agreement (MPIX_Comm_agree)
TAG_FT_REVOKE = 20    # worker->worker: comm-revocation poison frame
#                       ({cid, epoch, origin} JSON, sent direct over
#                       the full wire-up — no tree relay involved)

#: per-process cap on buffered fleet series points at the HNP (the
#: aggregation store is a ring too — a chatty worker cannot grow the
#: launcher without bound)
SERIES_KEEP = 8192
# pubsub tags + protocol live in runtime/pubsub.py; re-exported here
# for the worker-facing API
from .pubsub import (  # noqa: E402
    TAG_LOOKUP, TAG_PUBLISH, TAG_PUBSUB_REPLY, TAG_UNPUBLISH,
)


# ---------------------------------------------------------------------------
# binomial tree (routed/binomial analogue)
# ---------------------------------------------------------------------------

def binomial_parent(v: int) -> int:
    """Parent of node v in the 0-rooted binomial tree (clear lowest
    set bit — the classic MPI virtual-rank rule)."""
    return v & (v - 1)


def binomial_children(v: int, n: int) -> List[int]:
    """Children of node v among nodes 0..n-1."""
    out = []
    low = (v & -v) if v else (1 << max(1, n.bit_length()))
    b = 1
    while b < low and v + b < n:
        out.append(v + b)
        b <<= 1
    return out


def local_addr_toward(host: str, port: int = 9) -> str:
    """The local interface address a connection to ``host`` leaves
    from (UDP connect trick — no packet is sent). This is the REAL
    address to advertise in a modex card: tree peers on other machines
    must be able to dial it, so the 127.0.0.1 placeholder only
    survives when the HNP itself is on loopback."""
    import socket

    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((host, port or 9))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


def _pack_card(node_id: int, card: Dict[str, Any]) -> bytes:
    b = DssBuffer()
    b.pack_int64(node_id)
    b.pack_string(json.dumps(card))
    return b.tobytes()


def _unpack_card(raw: bytes):
    b = DssBuffer(raw)
    (node_id,) = b.unpack_int64()
    return int(node_id), json.loads(b.unpack_string())


class HnpCoordinator:
    """Node-0 side: owns the root listener, drives modex/barrier/xcast
    and monitors worker health.

    ``num_nodes`` counts every tree node including the HNP. When the
    HNP is a launcher (tpurun) rather than a participant, pass
    ``my_card=None`` to :meth:`run_modex` — the card list then holds
    only the workers' cards, ordered by node id (index = node_id - 1).
    """

    def __init__(self, num_nodes: int, port: int = 0,
                 bind_addr: str = "127.0.0.1") -> None:
        if num_nodes < 1:
            raise MPIError(ErrorCode.ERR_ARG, "num_nodes must be >= 1")
        self.num_nodes = num_nodes
        self.ep = OobEndpoint(0, port, bind_addr)
        self._barrier_seq = 0
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        # shared stop for the ft and migrate responders: created here
        # so either can be started standalone, in any order
        self._resp_stop = threading.Event()
        self._finished: set = set()
        self._failed: set = set()
        self._hb_lock = threading.Lock()
        # ULFM detection plane: the job epoch is bumped (and a
        # TAG_PROC_FAILED notice pushed to every live worker) whenever
        # the failure picture changes — promotion to failed, a respawn
        # grant, a replacement's rejoin
        self._ft_epoch = 0
        self._ft_restarted: set = set()   # node ids granted a respawn
        self._ft_rejoined: set = set()    # replacements re-wired
        #: nid -> epoch at which its current failure episode began:
        #: the AUTHORITATIVE episode record consumers like shrink()
        #: need — the transient `failed` set empties milliseconds
        #: after promotion under the restart policy, but the episode
        #: epoch is what decides deadness per communicator
        self._ft_failed_at: Dict[int, int] = {}
        # parked fault-tolerant agreements: (cid, aseq) -> slot
        self._ft_agree_lock = threading.Lock()
        self._ft_pending: Dict[tuple, Dict[str, Any]] = {}
        self._resusage: Dict[int, Dict[str, int]] = {}
        self._last_beat: Dict[int, float] = {}
        #: nid -> deadline until which SILENCE is excused: a respawned
        #: worker's first beat is gated on full process startup
        #: (interpreter + torch import + the card's context can exceed
        #: the whole interval*miss_limit window cold), so the monitor
        #: must not re-promote the replacement before it had any chance
        #: to beat — cleared by its first beat, bounded by the grace
        self._hb_restart_grace: Dict[int, float] = {}
        # Orphaned-subtree xcast fallback is the HNP's OWN duty, not an
        # optional caller poll: any HnpCoordinator user (tpurun,
        # participant-mode rank 0, direct tests) gets the drain.
        self._orphan_stop = threading.Event()
        self._orphan_thread = threading.Thread(
            target=self._orphan_loop, daemon=True
        )
        self._orphan_thread.start()

    def _orphan_loop(self) -> None:
        while not self._orphan_stop.is_set():
            try:
                self.serve_orphan_relay(timeout_ms=100)
            except Exception:
                if self._orphan_stop.is_set():
                    return
                time.sleep(0.1)

    @property
    def port(self) -> int:
        return self.ep.port

    @property
    def _worker_ids(self) -> List[int]:
        return list(range(1, self.num_nodes))

    def run_modex(self, my_card: Optional[Dict[str, Any]] = None, *,
                  timeout_ms: int = 30_000) -> List[Dict[str, Any]]:
        """Collect every worker's card, broadcast the full list
        (grpcomm_base_modex.c:67 allgather-through-daemons).

        my_card=None = launcher mode: the HNP contributes no card and
        the returned list is the workers', ordered by node id.
        """
        cards: Dict[int, Dict[str, Any]] = {}
        if my_card is not None:
            cards[0] = my_card
        expect = self.num_nodes if my_card is not None else self.num_nodes - 1
        first = 0 if my_card is not None else 1
        deadline = time.monotonic() + timeout_ms / 1000
        while len(cards) < expect:
            left = max(1, int((deadline - time.monotonic()) * 1000))
            src, _, raw = self.ep.recv(tag=TAG_JOIN, timeout_ms=left)
            nid, card = _unpack_card(raw)
            cards[nid] = card
            _log.verbose(2, f"modex: node {nid} joined ({len(cards)}/"
                            f"{expect})")
        ordered = [cards[i] for i in range(first, self.num_nodes)]
        payload = DssBuffer().pack_string(json.dumps(ordered)).tobytes()
        for nid in self._worker_ids:
            self.ep.send(nid, TAG_MODEX, payload)
        return ordered

    def barrier(self, *, timeout_ms: int = 30_000) -> None:
        """Wait for every worker's ENTER, then release all (the rte
        barrier of ompi_mpi_init.c:811)."""
        self._barrier_seq += 1
        seen = set()
        deadline = time.monotonic() + timeout_ms / 1000
        while len(seen) < self.num_nodes - 1:
            left = max(1, int((deadline - time.monotonic()) * 1000))
            src, _, raw = self.ep.recv(tag=TAG_BARRIER_ENTER,
                                       timeout_ms=left)
            seen.add(src)
        rel = DssBuffer().pack_int64(self._barrier_seq).tobytes()
        for nid in self._worker_ids:
            self.ep.send(nid, TAG_BARRIER_RELEASE, rel)

    def xcast(self, payload: bytes, tag: int = TAG_XCAST) -> None:
        """Broadcast down the binomial tree: send only to our tree
        children; workers relay to theirs (grpcomm xcast through
        routed/binomial — NOT a star loop)."""
        for nid in binomial_children(0, self.num_nodes):
            self.ep.send(nid, tag, payload)

    # -- health (sensor/heartbeat + errmgr hook) ---------------------------
    def start_heartbeat_monitor(
        self, on_failure: Callable[[int], None], *,
        interval_s: float = 1.0, miss_limit: int = 3,
    ) -> None:
        """Watch TAG_HEARTBEAT beats; a worker silent for
        ``miss_limit`` intervals (and not cleanly finished) is reported
        once via ``on_failure(node_id)``."""
        last = {nid: time.monotonic() for nid in self._worker_ids}
        self._last_beat = last  # ps snapshot reads beat ages

        def run() -> None:
            while not self._monitor_stop.is_set():
                try:
                    src, _, raw = self.ep.recv(
                        tag=TAG_HEARTBEAT,
                        timeout_ms=max(50, int(interval_s * 500)),
                    )
                    with self._hb_lock:
                        last[src] = time.monotonic()
                        # first beat of a respawned incarnation ends
                        # its startup grace: normal monitoring resumes
                        self._hb_restart_grace.pop(src, None)
                        if raw:  # piggybacked resusage sample
                            try:
                                self._resusage[src] = json.loads(raw)
                            except ValueError:
                                pass  # legacy empty/garbled beat
                except MPIError:
                    pass  # timeout: fall through to the check
                now = time.monotonic()
                newly_failed = []
                with self._hb_lock:
                    for nid in self._worker_ids:
                        if nid in self._finished or nid in self._failed:
                            continue
                        grace = self._hb_restart_grace.get(nid)
                        if grace is not None:
                            if now < grace:
                                continue  # still booting: excused
                            # grace expired with no beat: judge below
                            self._hb_restart_grace.pop(nid, None)
                        if now - last[nid] > interval_s * miss_limit:
                            self._failed.add(nid)
                            newly_failed.append(nid)
                # callback runs OUTSIDE the lock: errmgr policies may
                # re-enter (note_finished/recv_fin) or take seconds
                # (teardown) — neither may stall or deadlock the monitor
                for nid in newly_failed:
                    _log.verbose(
                        1, f"worker {nid} heartbeat lost "
                           f"({now - last[nid]:.1f}s silent)")
                    # ULFM promotion FIRST: bump the job epoch and push
                    # the TAG_PROC_FAILED notice before the errmgr
                    # policy runs, so survivors' bounded waits start
                    # raising ERR_PROC_FAILED even while the policy
                    # (teardown/respawn) is still deciding
                    self._ft_note_change(failed_nid=nid)
                    on_failure(nid)

        self._monitor = threading.Thread(target=run, daemon=True)
        self._monitor.start()

    def note_finished(self, nid: int) -> None:
        """Stop expecting beats from a cleanly-finished worker."""
        with self._hb_lock:
            self._finished.add(nid)

    # -- ULFM detection/agreement plane ------------------------------------
    def promote_failed(self, nid: int) -> bool:
        """Promote a worker to *failed* from an out-of-band observer
        (the launcher's waitpid loop seeing a nonzero exit long before
        the heartbeat window closes). Idempotent with the heartbeat
        monitor's own promotion; returns True when this call changed
        the picture (epoch bumped + notice pushed)."""
        with self._hb_lock:
            if nid in self._failed or nid in self._finished:
                return False
            self._failed.add(nid)
        self._ft_note_change(failed_nid=nid)
        return True

    def _ft_doc(self) -> Dict[str, Any]:
        """The authoritative failure picture as PROCESS indices (node
        ids and pidx differ by one — workers think in pidx)."""
        with self._hb_lock:
            return {
                "epoch": self._ft_epoch,
                "failed": sorted(n - 1 for n in self._failed),
                "restarted": sorted(n - 1 for n in self._ft_restarted),
                "rejoined": sorted(n - 1 for n in self._ft_rejoined),
                "failed_at": {str(n - 1): e for n, e
                              in sorted(self._ft_failed_at.items())},
            }

    def _ft_note_change(self, failed_nid: Optional[int] = None,
                        what: str = "") -> None:
        """Bump the job epoch and push a TAG_PROC_FAILED notice to
        every live worker (``failed_nid``, when given, is marked
        failed as part of the same epoch bump — callers that already
        marked it are unaffected, the add is idempotent). Notices go
        DIRECTLY over the lifelines (the HNP holds a link to every
        worker), not down the binomial tree: the dead worker may be
        exactly the relay node a tree descent would depend on."""
        with self._hb_lock:
            self._ft_epoch += 1
            if failed_nid is not None:
                self._failed.add(failed_nid)
                self._ft_failed_at[failed_nid] = self._ft_epoch
            live = [n for n in self._worker_ids
                    if n not in self._failed and n not in self._finished]
        if failed_nid is not None:
            # lifeline loss evicts the dead worker's published names:
            # a stale name must never be looked up by a later joiner
            # (the pubsub owner/TTL hygiene rule)
            tbl = getattr(self, "_ns_table", None)
            if tbl is not None:
                try:
                    tbl.evict_owner(failed_nid)
                except Exception:
                    pass  # name hygiene must not block the FT notice
        doc = self._ft_doc()
        payload = json.dumps(doc).encode()
        for nid in live:
            try:
                self.ep.send(nid, TAG_PROC_FAILED, payload)
            except MPIError:
                pass  # a link mid-death: that worker is next to fail
        _log.verbose(1, f"ft epoch {doc['epoch']}"
                        + (f" ({what})" if what else "")
                        + f": failed={doc['failed']} "
                          f"restarted={doc['restarted']} "
                          f"rejoined={doc['rejoined']}")
        # the failure picture changed: parked agreements may have lost
        # a participant they were waiting on
        self._ft_eval_agreements()

    def start_ft_responder(self) -> None:
        """Serve TAG_FT RPCs: ``{"op": "state"}`` queries answer with
        the current epoch/failed/restarted/rejoined picture; ``{"op":
        "agree"}`` contributions park until every live process of the
        agreement's group contributed (failed processes are excluded
        as they fail — re-evaluated on every epoch change), then every
        contributor gets the AND of the flags plus ONE consistent
        failure snapshot — the MPIX_Comm_agree contract that makes
        shrink's survivor group identical on every process. Shares the
        migrate responder's stop event (created in __init__), so start
        order does not matter."""

        def run() -> None:
            while not self._resp_stop.is_set():
                try:
                    src, _, raw = self.ep.recv(tag=TAG_FT,
                                               timeout_ms=200)
                except MPIError:
                    self._ft_eval_agreements()
                    continue
                try:
                    req = json.loads(raw or b"{}")
                except ValueError:
                    continue  # malformed frame: never kill the plane
                if req.get("op") == "agree":
                    try:
                        self._ft_park_agreement(src, req)
                    except Exception:
                        pass  # a garbled field costs that frame only
                    self._ft_eval_agreements()
                    continue
                doc = self._ft_doc()
                doc["seq"] = req.get("seq")
                try:
                    self.ep.send(src, TAG_FT, json.dumps(doc).encode())
                except MPIError:
                    pass  # client vanished between query and reply

        self._ft_thread = threading.Thread(
            target=run, daemon=True, name="hnp-ft")
        self._ft_thread.start()

    def _ft_park_agreement(self, src: int, req: Dict[str, Any]) -> None:
        key = (int(req["cid"]), int(req["aseq"]))
        pidx = int(req["pidx"])
        with self._ft_agree_lock:
            slot = self._ft_pending.setdefault(key, {
                "flags": {}, "src": {}, "seq": {},
                "procs": set(int(p) for p in req.get("procs", ())),
                "t": time.monotonic(),
            })
            slot["procs"] |= set(int(p) for p in req.get("procs", ()))
            slot["flags"][pidx] = int(req.get("flag", 0))
            slot["src"][pidx] = src
            slot["seq"][pidx] = req.get("seq")

    def _ft_eval_agreements(self) -> None:
        """Complete every parked agreement whose live participants all
        contributed (failed ones excused), and prune abandoned slots.
        The AND folds every flag that ARRIVED — including one from a
        process that failed after contributing, per the ULFM rule."""
        now = time.monotonic()
        done = []
        with self._hb_lock:
            failed_pidx = set(n - 1 for n in self._failed)
        with self._ft_agree_lock:
            for key, slot in list(self._ft_pending.items()):
                live = slot["procs"] - failed_pidx
                if live and not live.issubset(slot["flags"].keys()):
                    if now - slot["t"] > 120:
                        del self._ft_pending[key]  # abandoned
                    continue
                done.append(slot)
                del self._ft_pending[key]
        for slot in done:
            flag = 1
            for f in slot["flags"].values():
                flag &= int(f)
            doc = self._ft_doc()
            doc["flag"] = flag
            for pidx, src in slot["src"].items():
                doc["seq"] = slot["seq"].get(pidx)
                try:
                    self.ep.send(src, TAG_FT, json.dumps(doc).encode())
                except MPIError:
                    pass  # contributor died since; excused above next time

    def serve_orphan_relay(self, timeout_ms: int = 50) -> bool:
        """Drain one orphaned-subtree relay request: a worker whose
        tree-child link failed asks us to deliver the xcast directly
        (we hold a lifeline link to every worker). Returns True if a
        frame was served."""
        try:
            _, _, raw = self.ep.recv(tag=TAG_XCAST_ORPHAN,
                                     timeout_ms=max(1, timeout_ms))
        except MPIError:
            return False
        child = int.from_bytes(raw[:4], "big")
        tag = int.from_bytes(raw[4:8], "big")
        try:
            self.ep.send(child, tag, raw[8:])
            _log.verbose(1, f"delivered xcast directly to orphaned "
                            f"node {child}")
        except MPIError:
            _log.verbose(1, f"direct delivery to orphaned node "
                            f"{child} failed")
        return True

    # -- rejoin service (resilient-restart wire-up) ------------------------
    def start_rejoin_service(self, cards: List[Dict[str, Any]]) -> None:
        """After the initial wire-up, keep serving JOIN + init-barrier
        frames so a RESTARTED worker (rmaps/resilient respawn) can run
        the normal ESS bootstrap against a live job: its JOIN updates
        its card in place and gets the current card list back; its
        barrier ENTER is released immediately (the collective init
        barrier already happened — a lone rejoiner must not hang on
        it). Post-init ENTERs only ever come from rejoiners: the
        in-job data plane barriers ride the wire router, not the HNP.
        """
        self._rejoin_cards = cards
        self._rejoin_stop = threading.Event()

        def run() -> None:
            while not self._rejoin_stop.is_set():
                served = False
                try:
                    _, _, raw = self.ep.recv(tag=TAG_JOIN,
                                             timeout_ms=100)
                    served = True
                    try:
                        nid, card = _unpack_card(raw)
                    except Exception:
                        # a malformed JOIN must not kill the service:
                        # every later restart would hang at bootstrap
                        _log.verbose(1, "rejoin: dropping malformed "
                                        "JOIN frame")
                        continue
                    if not 1 <= nid <= len(self._rejoin_cards):
                        _log.verbose(1, f"rejoin: JOIN from unknown "
                                        f"node {nid}; dropped")
                        continue
                    self._rejoin_cards[nid - 1] = card
                    payload = DssBuffer().pack_string(
                        json.dumps(self._rejoin_cards)).tobytes()
                    self.ep.send(nid, TAG_MODEX, payload)
                    _log.verbose(1, f"rejoin: node {nid} re-wired")
                    # a RESPAWNED worker's rejoin completes the
                    # recovery wire-up: mark it and bump the epoch so
                    # survivors waiting in errmgr.recover() proceed.
                    # Survivors also re-JOIN (to refresh their card
                    # list) — those are not marked, only respawns.
                    with self._hb_lock:
                        respawned = (nid in self._ft_restarted
                                     and nid not in self._ft_rejoined)
                        if respawned:
                            self._ft_rejoined.add(nid)
                    if respawned:
                        self._ft_note_change(
                            what=f"worker {nid} rejoined")
                except MPIError:
                    pass
                try:
                    src, _, _ = self.ep.recv(tag=TAG_BARRIER_ENTER,
                                             timeout_ms=100)
                    rel = DssBuffer().pack_int64(-1).tobytes()
                    self.ep.send(src, TAG_BARRIER_RELEASE, rel)
                    served = True
                except MPIError:
                    pass
                if not served:
                    time.sleep(0.02)

        self._rejoin_thread = threading.Thread(target=run, daemon=True)
        self._rejoin_thread.start()

    def stop_rejoin_service(self) -> None:
        stop = getattr(self, "_rejoin_stop", None)
        if stop is not None:
            stop.set()
            self._rejoin_thread.join(timeout=2)

    #: seconds a respawned worker gets to deliver its FIRST beat
    #: before the monitor may judge it silent (cold process startup —
    #: interpreter, torch import, the card's context, the native
    #: libraries — routinely exceeds a sub-second heartbeat window; a
    #: replacement that stays silent past this is genuinely stuck and
    #: fails the normal way)
    RESTART_GRACE_S = 60.0

    def note_restarted(self, nid: int) -> None:
        """Forget a worker's failure/finish marks and reset its beat
        clock: the respawned incarnation is monitored afresh, with a
        startup grace until its first beat (see RESTART_GRACE_S).
        Bumps the job epoch (failed -> restarted) so survivors parked
        in recovery learn a replacement is on its way."""
        with self._hb_lock:
            self._failed.discard(nid)
            self._finished.discard(nid)
            self._resusage.pop(nid, None)
            self._ft_restarted.add(nid)
            self._ft_rejoined.discard(nid)
            self._hb_restart_grace[nid] = (time.monotonic()
                                           + self.RESTART_GRACE_S)
            if self._last_beat:
                self._last_beat[nid] = time.monotonic()
        self._ft_note_change(what=f"worker {nid} respawning")

    # -- ps/top snapshot service (orte-ps / orte-top HNP side) -------------
    def start_ps_responder(self, extra_fn: Optional[Callable] = None
                           ) -> None:
        """Serve TAG_PS queries: any client that dialed our port gets
        a JSON snapshot of per-worker health — last-beat age, pid,
        vmsize/rss from the piggybacked samples — plus whatever the
        launcher adds via ``extra_fn()`` (proc states, argv). The
        orte-ps/orte-top query path (``orte-ps.c`` pretty-prints what
        the HNP's sensor data already holds)."""

        def run() -> None:
            while not self._resp_stop.is_set():
                try:
                    src, _, _ = self.ep.recv(tag=TAG_PS, timeout_ms=200)
                except MPIError:
                    continue
                now = time.monotonic()
                with self._hb_lock:
                    workers = {
                        str(nid): {
                            "beat_age_s": (
                                round(now - self._last_beat[nid], 3)
                                if nid in self._last_beat else None),
                            "finished": nid in self._finished,
                            "failed": nid in self._failed,
                            **self._resusage.get(nid, {}),
                        }
                        for nid in self._worker_ids
                    }
                snap = {"num_workers": self.num_nodes - 1,
                        "workers": workers}
                if extra_fn is not None:
                    try:
                        snap.update(extra_fn())
                    except Exception:
                        pass  # a snapshot must never kill the responder
                try:
                    self.ep.send(src, TAG_PS, json.dumps(snap).encode())
                except MPIError:
                    pass  # client vanished between query and reply

        self._ps_thread = threading.Thread(target=run, daemon=True)
        self._ps_thread.start()

    # -- clock alignment (the obs-plane merge timebase) --------------------
    def start_clock_responder(self) -> None:
        """Serve TAG_CLOCK ping-pongs: echo the worker's payload back
        with OUR ``perf_counter`` reading appended. Workers run the
        classic NTP-style estimator (min-RTT sample, midpoint offset)
        against these replies, so every rank's journal timestamps can
        be mapped into ONE timebase — the HNP's — when tpu-doctor
        merges them. Shares the responders' stop event (created in
        __init__), so start order does not matter."""

        def run() -> None:
            while not self._resp_stop.is_set():
                try:
                    src, _, raw = self.ep.recv(tag=TAG_CLOCK,
                                               timeout_ms=200)
                except MPIError:
                    continue
                b = DssBuffer()
                b.pack_string(raw.decode("utf-8", "replace"))
                b.pack_string(repr(time.perf_counter()))
                try:
                    self.ep.send(src, TAG_CLOCK, b.tobytes())
                except MPIError:
                    pass  # client vanished between ping and pong

        self._clock_thread = threading.Thread(
            target=run, daemon=True, name="hnp-clock")
        self._clock_thread.start()

    # -- fleet series aggregation (the continuous metrics plane) -----------
    def start_series_responder(self) -> None:
        """Serve TAG_SERIES frames: a worker **push** (JSON with a
        ``points`` list) is folded into the per-process fleet store —
        a bounded ring per pidx, newest SERIES_KEEP points kept, with
        the worker's clock offset and push time alongside; any other
        frame is a **query** (tpu_top --fleet, tpu-doctor) answered
        with the whole fleet document. Shares the ps responder's stop
        event (created in __init__), so start order does not matter."""
        self._series_lock = threading.Lock()
        # pidx -> {"points": [..ring..], "clock_offset_s": float|None,
        #          "last_push": monotonic seconds}
        self._fleet_series: Dict[int, Dict[str, Any]] = {}

        def run() -> None:
            while not self._resp_stop.is_set():
                try:
                    src, _, raw = self.ep.recv(tag=TAG_SERIES,
                                               timeout_ms=200)
                except MPIError:
                    continue
                try:
                    doc = json.loads(raw) if raw else {}
                except ValueError:
                    continue  # malformed frame: never kill the store
                if isinstance(doc, dict) and "points" in doc:
                    try:
                        self._ingest_series(src, doc)
                    except Exception:
                        # a garbled push field (non-numeric pidx or
                        # offset from a version-skewed worker) costs
                        # that frame only — never the responder
                        pass
                    continue  # pushes are fire-and-forget
                try:
                    self.ep.send(src, TAG_SERIES,
                                 json.dumps(self.fleet_series()).encode())
                except MPIError:
                    pass  # client vanished between query and reply

        self._series_thread = threading.Thread(
            target=run, daemon=True, name="hnp-series")
        self._series_thread.start()

    def _ingest_series(self, src: int, doc: Dict[str, Any]) -> None:
        pidx = int(doc.get("pidx", src - 1))
        pts = [p for p in doc.get("points", ()) if isinstance(p, dict)]
        with self._series_lock:
            ent = self._fleet_series.setdefault(
                pidx, {"points": [], "clock_offset_s": None,
                       "last_push": None, "meta": {}})
            ent["points"].extend(pts)
            if len(ent["points"]) > SERIES_KEEP:
                del ent["points"][:len(ent["points"]) - SERIES_KEEP]
            if doc.get("clock_offset_s") is not None:
                ent["clock_offset_s"] = float(doc["clock_offset_s"])
            if isinstance(doc.get("meta"), dict):
                ent["meta"] = doc["meta"]
            ent["last_push"] = time.monotonic()

    def fleet_series(self) -> Dict[str, Any]:
        """The aggregated fleet document: per-pidx point rings with
        each worker's clock offset (consumers correct ``t`` into the
        HNP timebase by adding it) and the seconds since its last
        push (staleness marker for the dashboard)."""
        now = time.monotonic()
        lock = getattr(self, "_series_lock", None)
        if lock is None:
            return {"procs": {}}
        with lock:
            return {"procs": {
                str(pidx): {
                    "points": list(ent["points"]),
                    "clock_offset_s": ent["clock_offset_s"],
                    "push_age_s": (round(now - ent["last_push"], 3)
                                   if ent["last_push"] is not None
                                   else None),
                    "meta": dict(ent.get("meta") or {}),
                }
                for pidx, ent in sorted(self._fleet_series.items())
            }}

    def kill_worker(self, node_id: int, code: int = 143) -> None:
        """Order a worker to exit via its die watcher (the odls kill
        path — reaches THE WORKER ITSELF even when it was launched
        through an ssh conduit whose local client process is all the
        launcher could otherwise signal)."""
        self.ep.send(node_id, TAG_DIE, str(code).encode())

    def start_migrate_responder(self, migrate_fn: Callable) -> None:
        """Serve TAG_MIGRATE requests (the ``orte-migrate`` command
        path): payload is JSON ``{"off": host}``; ``migrate_fn`` is
        the launcher's policy hook and its dict return is the reply.
        Runs on its own thread; shares the ft responder's stop event
        (created in __init__, so start order does not matter) and is
        stopped by the same stop_responders call."""

        def run() -> None:
            while not self._resp_stop.is_set():
                try:
                    src, _, raw = self.ep.recv(tag=TAG_MIGRATE,
                                               timeout_ms=200)
                except MPIError:
                    continue
                try:
                    req = json.loads(raw or b"{}")
                    reply = migrate_fn(req)
                except Exception as exc:  # never kill the responder
                    reply = {"ok": False, "error": str(exc)}
                try:
                    self.ep.send(src, TAG_MIGRATE,
                                 json.dumps(reply).encode())
                except MPIError:
                    pass

        self._migrate_thread = threading.Thread(
            target=run, daemon=True, name="hnp-migrate")
        self._migrate_thread.start()

    def stop_responders(self) -> None:
        self._resp_stop.set()
        # the migrate thread gets a much longer budget:
        # an in-flight migrate_fn kills/respawns ranks (seconds of
        # process teardown/launch) and mutates Job state — shutdown
        # must wait for it, not race it with ep.close()
        for name, budget in (("_ps_thread", 2), ("_migrate_thread", 30),
                             ("_clock_thread", 2), ("_series_thread", 2),
                             ("_ft_thread", 2)):
            t = getattr(self, name, None)
            if t is not None:
                t.join(timeout=budget)
                if t.is_alive():
                    _log.verbose(
                        1, f"{name} still running after {budget}s join "
                           "at shutdown; proceeding")


    # -- name service (pubsub_orte / orte-server analogue) -----------------
    def start_name_server(self) -> None:
        """Serve publish/lookup/unpublish frames: the HNP plays the
        ``orte-server`` role for its own job's workers. The protocol
        (seq correlation, parked lookups with client TTLs, malformed-
        frame tolerance) is the shared runtime/pubsub.py
        implementation."""
        from .pubsub import PubsubTable

        self._ns_table = PubsubTable(self.ep)
        self._ns_stop = threading.Event()
        self._ns_thread = threading.Thread(
            target=self._ns_table.serve_loop, args=(self._ns_stop,),
            daemon=True,
        )
        self._ns_thread.start()

    def stop_name_server(self) -> None:
        stop = getattr(self, "_ns_stop", None)
        if stop is not None:
            stop.set()
            self._ns_thread.join(timeout=2)

    def recv_fin(self, timeout_ms: int = 1000) -> Optional[int]:
        """Drain one worker-completion report (returns node id)."""
        try:
            src, _, _ = self.ep.recv(tag=TAG_FIN, timeout_ms=timeout_ms)
        except MPIError:
            return None
        self.note_finished(src)
        return src

    def shutdown(self) -> None:
        self._monitor_stop.set()
        self._orphan_stop.set()
        self.stop_name_server()
        self.stop_responders()
        self.stop_rejoin_service()
        try:
            # teardown release goes to every worker directly: tree
            # relays may already be gone at shutdown
            for nid in self._worker_ids:
                try:
                    self.ep.send(nid, TAG_FIN, b"")
                except MPIError:
                    pass
        finally:
            if self._monitor is not None:
                self._monitor.join(timeout=2)
            self._orphan_thread.join(timeout=2)
            self.ep.close()


class WorkerAgent:
    """Per-process agent (the orted-equivalent participant)."""

    def __init__(self, node_id: int, hnp_host: str, hnp_port: int,
                 num_nodes: Optional[int] = None) -> None:
        if node_id < 1:
            raise MPIError(ErrorCode.ERR_ARG,
                           "worker node_id must be >= 1 (0 is the HNP)")
        self.node_id = node_id
        self.num_nodes = num_nodes  # tree size (incl. HNP); set by modex
        # advertise the interface that actually faces the HNP; when
        # the HNP is off-host our listener must accept from other
        # machines too (tree links are worker-to-worker)
        self.local_addr = local_addr_toward(hnp_host, hnp_port)
        bind = ("127.0.0.1" if self.local_addr.startswith("127.")
                else "0.0.0.0")
        self.ep = OobEndpoint(node_id, 0, bind)
        self.ep.connect(0, hnp_host, hnp_port)
        self.ep.set_default_route(0)  # everything flows toward the root
        self.cards: List[Dict[str, Any]] = []
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        # created HERE, not lazily: two threads' first RPCs racing a
        # lazy check-then-set would mint two locks and defeat the
        # reply serialization pubsub_rpc requires
        self._pubsub_lock = threading.Lock()
        # same discipline for clock ping-pongs (the dump path and an
        # operator SIGUSR1 can race a finalize-time sync)
        self._clock_lock = threading.Lock()
        # and for series pushes (sampler tick vs finalize flush)
        self._series_lock = threading.Lock()
        # TAG_FT RPCs (state queries + agreements): one outstanding
        # per process, seq-correlated because a parked agreement's
        # reply can arrive arbitrarily late
        self._ft_lock = threading.Lock()
        self._ft_seq = 0
        self._ft_watcher: Optional[threading.Thread] = None

    def run_modex(self, my_card: Dict[str, Any], *,
                  timeout_ms: int = 30_000) -> List[Dict[str, Any]]:
        """JOIN with our card; receive the ordered card list. The card
        should carry ``oob_port`` (our listen port) so tree links can
        be formed afterwards (see :meth:`setup_tree`)."""
        my_card = dict(my_card)
        my_card.setdefault("oob_port", self.ep.port)
        my_card.setdefault("oob_host", self.local_addr)
        self.ep.send(0, TAG_JOIN, _pack_card(self.node_id, my_card))
        _, _, raw = self.ep.recv(tag=TAG_MODEX, timeout_ms=timeout_ms)
        self.cards = json.loads(DssBuffer(raw).unpack_string())
        return self.cards

    # -- tree (routed/binomial links for xcast relay) ----------------------
    def setup_tree(self, num_nodes: int,
                   worker_cards: List[Dict[str, Any]]) -> None:
        """Connect to our binomial-tree parent (if it is a worker; the
        HNP link already exists). ``worker_cards[i]`` MUST be node
        (i+1)'s card (launcher-mode modex returns exactly this;
        participant-mode callers pass ``cards[1:]`` to drop the HNP's
        card). Children connect to us the same way, so after the
        post-tree barrier every tree edge is live."""
        self.num_nodes = num_nodes
        parent = binomial_parent(self.node_id)
        if parent != 0:
            card = worker_cards[parent - 1]
            self.ep.connect(parent, card["oob_host"],
                            int(card["oob_port"]))

    @property
    def tree_children(self) -> List[int]:
        if not self.num_nodes:
            return []
        return binomial_children(self.node_id, self.num_nodes)

    def barrier(self, *, timeout_ms: int = 30_000) -> None:
        self.ep.send(0, TAG_BARRIER_ENTER, b"")
        self.ep.recv(tag=TAG_BARRIER_RELEASE, timeout_ms=timeout_ms)

    def recv_xcast(self, tag: int = TAG_XCAST, *,
                   timeout_ms: int = 30_000) -> bytes:
        """Receive a tree broadcast and relay it to our children
        FIRST (pipelined descent), then deliver locally."""
        _, _, raw = self.ep.recv(tag=tag, timeout_ms=timeout_ms)
        # The child's hello frame is processed on our reader thread
        # with no ordering guarantee against the HNP barrier release,
        # so the first relay can race peer_fd registration. First pass
        # attempts every child (keeping the descent pipelined for the
        # reachable ones), then only the failures are retried with
        # backoff; a child still unreachable is handed to the HNP,
        # which holds a lifeline link to every worker.
        failed = []
        for child in self.tree_children:
            try:
                self.ep.send(child, tag, raw)
            except MPIError:
                failed.append(child)
        for attempt in range(4):
            if not failed:
                break
            time.sleep(0.05 * (attempt + 1))
            still = []
            for child in failed:
                try:
                    self.ep.send(child, tag, raw)
                except MPIError:
                    still.append(child)
            failed = still
        for child in failed:
            _log.verbose(1, f"xcast relay to child {child} failed "
                            "after retries; deferring to HNP")
            try:
                hdr = (int(child).to_bytes(4, "big")
                       + int(tag).to_bytes(4, "big"))
                self.ep.send(0, TAG_XCAST_ORPHAN, hdr + raw)
            except MPIError:
                _log.verbose(1, "HNP fallback for orphaned "
                                f"subtree {child} also failed")
        return raw

    # -- name service client (MPI_Publish_name over the lifeline) ----------
    def _pubsub_rpc(self, tag: int, *fields: str, timeout_ms: int = 10_000):
        from .pubsub import pubsub_rpc

        return pubsub_rpc(self.ep, self._pubsub_lock, self, tag,
                          *fields, timeout_ms=timeout_ms)

    def publish_name(self, service: str, port: str) -> None:
        ok, msg = self._pubsub_rpc(TAG_PUBLISH, service, port)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"publish '{service}': {msg}")

    def lookup_name(self, service: str, *,
                    timeout_ms: int = 10_000) -> str:
        """Blocks until the name is published (the server parks us
        with our deadline, so abandoned lookups expire server-side)
        or the recv times out."""
        ok, value = self._pubsub_rpc(TAG_LOOKUP, service, str(timeout_ms),
                                     timeout_ms=timeout_ms)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"lookup '{service}' failed: {value}")
        return value

    def unpublish_name(self, service: str) -> None:
        ok, msg = self._pubsub_rpc(TAG_UNPUBLISH, service)
        if not ok:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"unpublish '{service}': not published")

    # -- clock alignment ---------------------------------------------------
    def clock_sync(self, rounds: int = 8,
                   timeout_ms: int = 2000) -> tuple:
        """Estimate this process's ``perf_counter`` offset to the
        HNP's via TAG_CLOCK ping-pongs: offset = hnp_mid - local_mid
        of the MINIMUM-RTT sample (the NTP discipline — the tightest
        round trip bounds the asymmetry error by rtt/2). Returns
        ``(offset_s, rtt_s)``; adding ``offset_s`` to a local
        perf_counter reading yields HNP time. Raises ERR_PENDING when
        no pong arrives (responder not running)."""
        import uuid as _uuid

        best: Optional[tuple] = None
        with self._clock_lock:
            for i in range(max(1, rounds)):
                nonce = _uuid.uuid4().hex[:16]
                t0 = time.perf_counter()
                try:
                    self.ep.send(0, TAG_CLOCK, nonce.encode())
                    deadline = time.monotonic() + timeout_ms / 1000
                    while True:
                        left = max(1, int((deadline - time.monotonic())
                                          * 1000))
                        _, _, raw = self.ep.recv(tag=TAG_CLOCK,
                                                 timeout_ms=left)
                        t1 = time.perf_counter()
                        b = DssBuffer(raw)
                        if b.unpack_string() == nonce:
                            break  # stale pong from an abandoned
                            #        round: keep draining inside this
                            #        round's budget until ours arrives
                except MPIError:
                    if best is None:
                        raise  # responder absent: surface it
                    break      # got samples; a late timeout ends early
                th = float(b.unpack_string())
                rtt = t1 - t0
                off = th - (t0 + t1) / 2
                if best is None or rtt < best[1]:
                    best = (off, rtt)
        return best

    # -- fleet series push (the continuous metrics plane) ------------------
    def push_series(self, points, offset_s=None, meta=None) -> None:
        """Fire-and-forget push of new sampler points to the HNP's
        fleet store. The worker's process_index rides in the frame
        (node ids and pidx differ by one), plus the current clock
        offset so the HNP-side document is mergeable onto one
        timeline and optional identity meta (rank span) so dashboards
        can label rows. Raises MPIError when the lifeline is gone —
        the sampler counts failures and stops trying."""
        pidx = self.node_id - 1
        doc = {"pidx": pidx, "points": list(points),
               "clock_offset_s": offset_s}
        if meta:
            doc["meta"] = dict(meta)
        with self._series_lock:
            self.ep.send(0, TAG_SERIES, json.dumps(doc).encode())

    def query_fleet_series(self, *, timeout_ms: int = 5_000) -> Dict:
        """Ask the HNP for the aggregated fleet document (mostly for
        tests; dashboards use tools.tpu_top.FleetClient)."""
        with self._series_lock:
            self.ep.send(0, TAG_SERIES, b"{}")
            _, _, raw = self.ep.recv(tag=TAG_SERIES,
                                     timeout_ms=timeout_ms)
        return json.loads(raw)

    # -- ULFM failure plane ------------------------------------------------
    def start_ft_watcher(self, on_notice, on_revoke=None) -> None:
        """Watch the failure plane: TAG_PROC_FAILED notices from the
        HNP (epoch bumps) are handed to ``on_notice(doc)``, and
        TAG_FT_REVOKE poison frames from peer workers to
        ``on_revoke(cid, epoch)``. One thread alternates bounded
        receives on both tags (the OOB recv is tag-filtered, so this
        coexists with the heartbeat/die-watcher threads on the same
        endpoint); worst-case delivery latency is one loop pass —
        far inside the heartbeat detection interval. Stops with the
        heartbeat stop event (both are the process-management
        channel)."""
        if self._ft_watcher is not None and self._ft_watcher.is_alive():
            return

        def run() -> None:
            from ..utils.errors import ErrorCode as _EC

            while not self._hb_stop.is_set():
                for tag, timeout in ((TAG_PROC_FAILED, 150),
                                     (TAG_FT_REVOKE, 50)):
                    try:
                        _, _, raw = self.ep.recv(tag=tag,
                                                 timeout_ms=timeout)
                    except MPIError as e:
                        if e.code == _EC.ERR_PENDING:
                            continue  # plain timeout: keep watching
                        return        # endpoint closed/torn down
                    except Exception:
                        return
                    try:
                        doc = json.loads(raw or b"{}")
                    except ValueError:
                        continue  # malformed frame: never kill the plane
                    try:
                        if tag == TAG_PROC_FAILED:
                            on_notice(doc)
                        elif on_revoke is not None:
                            on_revoke(int(doc["cid"]),
                                      int(doc.get("epoch", -1)))
                    except Exception as e:
                        _log.verbose(1, f"ft watcher handler "
                                        f"failed: {e}")

        self._ft_watcher = threading.Thread(
            target=run, daemon=True, name="ft-watcher")
        self._ft_watcher.start()

    def _ft_rpc(self, req: Dict[str, Any], *,
                timeout_ms: int = 10_000) -> Dict[str, Any]:
        """One seq-correlated TAG_FT round trip. Replies carrying a
        stale seq (an agreement abandoned by an earlier timeout) are
        drained and dropped."""
        with self._ft_lock:
            self._ft_seq += 1
            seq = f"{self.node_id}:{self._ft_seq}"
            req = dict(req)
            req["seq"] = seq
            self.ep.send(0, TAG_FT, json.dumps(req).encode())
            deadline = time.monotonic() + timeout_ms / 1000
            while True:
                left = max(1, int((deadline - time.monotonic()) * 1000))
                _, _, raw = self.ep.recv(tag=TAG_FT, timeout_ms=left)
                try:
                    doc = json.loads(raw)
                except ValueError:
                    continue
                if doc.get("seq") == seq:
                    return doc

    def ft_query(self, *, timeout_ms: int = 10_000) -> Dict[str, Any]:
        """The authoritative failure picture from the HNP: epoch,
        failed/restarted/rejoined process indices. Raises ERR_PENDING
        when the ft responder is not running."""
        return self._ft_rpc({"op": "state"}, timeout_ms=timeout_ms)

    def ft_agree(self, cid: int, aseq: int, flag: int, procs,
                 *, timeout_ms: int = 60_000) -> Dict[str, Any]:
        """Fault-tolerant agreement (MPIX_Comm_agree): contribute
        ``flag`` for agreement ``(cid, aseq)`` among ``procs`` and
        block until every live participant contributed. The reply
        carries the AND of the contributed flags plus ONE consistent
        epoch/failed snapshot shared by all participants — the
        foundation shrink builds its survivor group on."""
        return self._ft_rpc(
            {"op": "agree", "cid": int(cid), "aseq": int(aseq),
             "pidx": self.node_id - 1, "flag": int(flag),
             "procs": [int(p) for p in procs]},
            timeout_ms=timeout_ms)

    def ft_revoke_notify(self, peer_pidx: int, cid: int,
                         epoch: int) -> None:
        """Push one revocation poison frame to a peer worker (the
        revoke propagation step; best-effort — a dead peer needs no
        poison)."""
        doc = {"cid": int(cid), "epoch": int(epoch),
               "origin": self.node_id - 1}
        self.ep.send(peer_pidx + 1, TAG_FT_REVOKE,
                     json.dumps(doc).encode())

    # -- health ------------------------------------------------------------
    def heartbeat(self) -> None:
        """Beat, piggybacking a resource-usage sample (the
        sensor/resusage data orte-ps/orte-top display,
        ``sensor_resusage.c`` feeding the HNP): pid + vmsize/rss ride
        every beat, so the HNP always holds a fresh per-rank sample
        without a second sampling channel."""
        from ..ft.sensor import resource_usage

        ru = resource_usage()
        ru["pid"] = os.getpid()
        self.ep.send(0, TAG_HEARTBEAT, json.dumps(ru).encode())

    def start_heartbeats(self, interval_s: float = 1.0) -> None:
        def run() -> None:
            while not self._hb_stop.wait(interval_s):
                try:
                    self.heartbeat()
                except MPIError:
                    return  # lifeline gone; process teardown follows

        self._hb_thread = threading.Thread(target=run, daemon=True)
        self._hb_thread.start()
        self._start_die_watcher()

    def _start_die_watcher(self) -> None:
        """Obey TAG_DIE from the HNP with ``os._exit`` (the odls
        kill_local_procs analogue, ``orte/mca/odls/base``): when the
        launcher reached the worker over ssh, terminating the LOCAL
        ssh client merely orphans the remote process — the reference
        kills through the remote orted, and this control-plane kill
        is that path here. Runs whenever heartbeats run (both are the
        process-management channel)."""

        def run() -> None:
            from ..utils.errors import ErrorCode as _EC

            while not self._hb_stop.is_set():
                try:
                    _, _, raw = self.ep.recv(tag=TAG_DIE,
                                             timeout_ms=500)
                except MPIError as e:
                    if e.code == _EC.ERR_PENDING:
                        continue  # plain timeout: keep watching
                    return        # endpoint closed/torn down
                except Exception:
                    return
                os._exit(int(raw or b"143"))

        threading.Thread(target=run, daemon=True,
                         name="die-watcher").start()

    def stop_heartbeats(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)

    # -- teardown ----------------------------------------------------------
    def send_fin(self) -> None:
        """Report clean completion to the HNP (IOF_COMPLETE analogue)."""
        self.ep.send(0, TAG_FIN, b"")

    def wait_fin(self, *, timeout_ms: int = 60_000) -> None:
        self.ep.recv(tag=TAG_FIN, timeout_ms=timeout_ms)
        self.close()

    def close(self) -> None:
        self.stop_heartbeats()
        self.ep.close()

