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

Not ported yet: the ULFM detection/agreement plane (epoch notices,
``ft_agree``, revocation), the rejoin/migrate/ps/clock/series
responders (restart, ``tpu_ps`` and the observability plane).

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
#                       (9-12 are the pubsub name-service tags)
TAG_DIE = 15          # HNP->worker: exit immediately (odls kill)

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
        self._finished: set = set()
        self._failed: set = set()
        self._hb_lock = threading.Lock()
        self._resusage: Dict[int, Dict[str, int]] = {}
        self._last_beat: Dict[int, float] = {}
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
                    on_failure(nid)

        self._monitor = threading.Thread(target=run, daemon=True)
        self._monitor.start()

    def note_finished(self, nid: int) -> None:
        """Stop expecting beats from a cleanly-finished worker."""
        with self._hb_lock:
            self._finished.add(nid)

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


    def kill_worker(self, node_id: int, code: int = 143) -> None:
        """Order a worker to exit via its die watcher (the odls kill
        path — reaches THE WORKER ITSELF even when it was launched
        through an ssh conduit whose local client process is all the
        launcher could otherwise signal)."""
        self.ep.send(node_id, TAG_DIE, str(code).encode())


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

    # -- health ------------------------------------------------------------
    def heartbeat(self) -> None:
        """Beat, piggybacking a resource-usage sample (the
        sensor/resusage data orte-ps/orte-top display,
        ``sensor_resusage.c`` feeding the HNP): pid + vmsize/rss ride
        every beat, so the HNP always holds a fresh per-rank sample
        without a second sampling channel."""
        ru = _resource_usage()
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


def _resource_usage() -> Dict[str, int]:
    """This process's vmsize/rss in bytes (``/proc/self/statm``; zeros
    where it is missing) — the sample every heartbeat carries."""
    try:
        with open("/proc/self/statm") as f:
            vm, rss = (int(v) for v in f.read().split()[:2])
        page = os.sysconf("SC_PAGE_SIZE")
        return {"vmsize": vm * page, "rss": rss * page}
    except (OSError, ValueError):
        return {"vmsize": 0, "rss": 0}
