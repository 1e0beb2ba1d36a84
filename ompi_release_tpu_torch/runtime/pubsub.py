"""Shared pubsub wire protocol — one implementation for every server
(the port's copy of ``ompi_release_tpu/runtime/pubsub.py``).

The name-service protocol (seq-correlated publish/lookup/unpublish
frames over the OOB, parked lookups with client-supplied TTLs) is
served by TWO hosts: a tpurun job's HNP (``coordinator.py``, the
pubsub_orte role for the job's own workers) and the standalone
cross-job ``tpu-server`` (the orte-server role). Both instantiate
:class:`PubsubTable` and drive :func:`serve_once`; clients share
:func:`pubsub_rpc`. One wire format, one parking/pruning policy — a
protocol change lands in exactly one place.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from ..native import DssBuffer
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("pubsub")

TAG_PUBLISH = 9       # client->server: publish service name
TAG_LOOKUP = 10       # client->server: lookup service name
TAG_PUBSUB_REPLY = 11  # server->client: response (seq-correlated)
TAG_UNPUBLISH = 12    # client->server: unpublish service name

SERVE_TAGS = (TAG_PUBLISH, TAG_LOOKUP, TAG_UNPUBLISH)


class PubEntry:
    """One published name: value + OWNER identity (the publishing
    client's node id — the handle evictions key on) + optional
    expiry. Owner/TTL are the multi-tenant hygiene additions: a dead
    tenant's stale names must never be looked up by the next tenant,
    so entries die with their owner's lifeline/lease or with their
    TTL, whichever comes first."""

    __slots__ = ("value", "owner", "expire_at")

    def __init__(self, value: str, owner: Optional[int] = None,
                 expire_at: Optional[float] = None) -> None:
        self.value = value
        self.owner = owner
        self.expire_at = expire_at

    def expired(self, now: float) -> bool:
        return self.expire_at is not None and now >= self.expire_at


class PubsubTable:
    """Server-side name table + parked lookups (pubsub_orte core)."""

    def __init__(self, ep) -> None:
        self.ep = ep
        self.names: Dict[str, PubEntry] = {}
        # service -> [(client_id, seq, expire_at)]
        self.waiters: Dict[str, List[Tuple[int, int, float]]] = {}
        #: guards names/waiters: the serve thread owns almost every
        #: access, but ``evict_owner`` is called cross-thread (the
        #: HNP's FT path on worker lifeline loss, a daemon eviction
        #: listener) and must not race prune()/handle() mid-mutation
        self._table_lock = threading.RLock()
        # per-instance so subclasses can serve extra RPCs (the
        # tpu_server metrics page) without widening every host
        self.serve_tags: List[int] = list(SERVE_TAGS)

    def _reply(self, nid: int, seq: int, ok: bool, value: str) -> None:
        frame = DssBuffer()
        frame.pack_int64(seq)
        frame.pack_int64(1 if ok else 0)
        frame.pack_string(value)
        try:
            self.ep.send(nid, TAG_PUBSUB_REPLY, frame.tobytes())
        except MPIError:
            _log.verbose(1, f"pubsub reply to {nid} failed")

    def prune(self) -> None:
        """Drop parked lookups whose client gave up (the lookup frame
        carries the client's deadline, so abandoned waiters cannot
        accumulate) AND published entries past their TTL — prune runs
        every serve iteration, so expiry is enforced continuously,
        not only at the next lookup."""
        now = time.monotonic()
        with self._table_lock:
            for service in list(self.waiters):
                alive = [w for w in self.waiters[service]
                         if w[2] > now]
                if alive:
                    self.waiters[service] = alive
                else:
                    del self.waiters[service]
            for service in [s for s, e in self.names.items()
                            if e.expired(now)]:
                del self.names[service]
                _log.verbose(1, f"pruned expired name '{service}'")

    def evict_owner(self, owner: int) -> List[str]:
        """Drop every name published by ``owner`` — the lifeline-loss
        / lease-expiry hook (HNP worker death, daemon tenant
        eviction). Returns the evicted service names. Parked waiters
        on those names stay parked: their own TTLs bound them, and a
        re-publish by a live owner still unparks them."""
        with self._table_lock:
            gone = [s for s, e in self.names.items()
                    if e.owner == owner]
            for service in gone:
                del self.names[service]
        if gone:
            _log.verbose(1, f"evicted {len(gone)} name(s) of dead "
                            f"owner {owner}: {gone}")
        return gone

    def publish_local(self, service: str, value: str,
                      owner: Optional[int] = None,
                      ttl_s: Optional[float] = None) -> bool:
        """Server-side publish (the daemon's own entries). False on a
        live duplicate."""
        now = time.monotonic()
        with self._table_lock:
            existing = self.names.get(service)
            if existing is not None and not existing.expired(now):
                return False
            self.names[service] = PubEntry(
                value, owner,
                now + float(ttl_s) if ttl_s is not None else None)
            unpark = self.waiters.pop(service, [])
        for wnid, wseq, _exp in unpark:
            self._reply(wnid, wseq, True, value)
        return True

    def handle(self, tag: int, src: int, raw: bytes) -> None:
        b = DssBuffer(raw)
        (seq,) = b.unpack_int64()
        service = b.unpack_string()
        now = time.monotonic()
        if tag == TAG_PUBLISH:
            port = b.unpack_string()
            # optional trailing TTL field (newer clients); absence —
            # an exhausted buffer — is the legacy no-TTL publish
            ttl_s = None
            try:
                ttl_ms = int(b.unpack_string())
                if ttl_ms > 0:
                    ttl_s = ttl_ms / 1000
            except (MPIError, ValueError):
                pass
            with self._table_lock:
                existing = self.names.get(service)
                if existing is not None and not existing.expired(now):
                    self._reply(src, seq, False, "already published")
                    return
                # the publisher's node id IS the owner identity:
                # evictions (owner lifeline loss, tenant lease
                # expiry) key on it
                self.names[service] = PubEntry(
                    port, src,
                    now + ttl_s if ttl_s is not None else None)
                unpark = self.waiters.pop(service, [])
            self._reply(src, seq, True, port)
            for wnid, wseq, _exp in unpark:
                self._reply(wnid, wseq, True, port)
        elif tag == TAG_UNPUBLISH:
            with self._table_lock:
                ok = self.names.pop(service, None) is not None
            self._reply(src, seq, ok, service)
        else:  # TAG_LOOKUP
            ttl_ms = int(b.unpack_string())
            with self._table_lock:
                entry = self.names.get(service)
                if entry is not None and entry.expired(now):
                    # lazy expiry backstop
                    self.names.pop(service, None)
                    entry = None
                if entry is None:
                    expire = time.monotonic() + ttl_ms / 1000
                    self.waiters.setdefault(service, []).append(
                        (src, seq, expire)
                    )
            if entry is not None:
                self._reply(src, seq, True, entry.value)

    def serve_once(self, timeout_ms: int = 50) -> None:
        """One serve iteration: prune, then drain one frame per tag.
        One malformed frame must not kill the service."""
        self.prune()
        for tag in self.serve_tags:
            try:
                src, _, raw = self.ep.recv(tag=tag,
                                           timeout_ms=timeout_ms)
            except MPIError:
                continue
            try:
                self.handle(tag, src, raw)
            except Exception as exc:
                _log.verbose(1, f"dropping bad pubsub frame from "
                                f"{src}: {exc}")

    def serve_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            self.serve_once()


def pubsub_rpc(ep, lock: threading.Lock, seq_holder, tag: int,
               *fields: str, server_id: int = 0,
               timeout_ms: int = 10_000) -> Tuple[bool, str]:
    """Client side: send one request, wait for OUR seq's reply.

    Concurrent RPCs on one endpoint do NOT serialize behind each
    other: replies are demultiplexed by seq through a shared stash —
    one thread at a time plays receiver (condition-variable handoff),
    parks replies that belong to other outstanding RPCs, and wakes
    their owners. A publish issued while another thread's lookup is
    parked server-side therefore completes immediately (and typically
    unparks that very lookup) instead of waiting out its timeout.

    ``lock`` protects only seq allocation + the request send (frame
    ordering); ``seq_holder`` is any object with a mutable
    ``pubsub_seq`` int attribute."""
    with lock:
        # mux creation under the lock: two first-RPC threads racing an
        # unsynchronized check-then-set would mint two muxes and strand
        # one thread's replies in the orphaned stash
        state = getattr(ep, "_pubsub_mux", None)
        if state is None:
            state = ep._pubsub_mux = {
                "cond": threading.Condition(),
                "replies": {},      # seq -> (ok, value)
                "receiving": False,  # one thread owns the recv at a time
            }
        seq_holder.pubsub_seq = getattr(seq_holder, "pubsub_seq", 0) + 1
        seq = seq_holder.pubsub_seq
        frame = DssBuffer()
        frame.pack_int64(seq)
        for f in fields:
            frame.pack_string(f)
        ep.send(server_id, tag, frame.tobytes())
    cond = state["cond"]
    deadline = time.monotonic() + timeout_ms / 1000
    while True:
        with cond:
            if seq in state["replies"]:
                ok, value = state["replies"].pop(seq)
                return bool(ok), value
            left = deadline - time.monotonic()
            if left <= 0:
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"pubsub rpc seq={seq} timed out",
                )
            if state["receiving"]:
                # another thread is on the wire; it will park our
                # reply and wake us
                cond.wait(timeout=min(left, 0.5))
                continue
            state["receiving"] = True
        got_seq = None
        try:
            left_ms = max(1, int((deadline - time.monotonic()) * 1000))
            _, _, raw = ep.recv(tag=TAG_PUBSUB_REPLY,
                                timeout_ms=min(left_ms, 500))
            try:
                b = DssBuffer(raw)
                (got_seq,) = b.unpack_int64()
                (ok,) = b.unpack_int64()
                value = b.unpack_string()
            except Exception:
                # one garbled reply frame must cost only that frame —
                # never wedge the receiver handoff for the process
                _log.verbose(1, "dropping malformed pubsub reply")
                got_seq = None
        except MPIError:
            if time.monotonic() >= deadline:
                with cond:
                    state["receiving"] = False
                    cond.notify_all()
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"pubsub rpc seq={seq} timed out",
                )
        with cond:
            state["receiving"] = False
            if got_seq is not None:
                if got_seq == seq:
                    cond.notify_all()
                    return bool(ok), value
                # another outstanding RPC's reply: park it and wake
                # its owner; cap the stash so replies to long-dead
                # RPCs cannot accumulate
                state["replies"][int(got_seq)] = (int(ok), value)
                if len(state["replies"]) > 64:
                    state["replies"].pop(next(iter(state["replies"])))
            cond.notify_all()


# ---------------------------------------------------------------------------
# the public name-service API (MPI_Publish_name / MPI_Lookup_name)
# ---------------------------------------------------------------------------

#: the process-local table of a singleton (no tpurun job)
_local_names: Dict[str, str] = {}
_local_cv = threading.Condition()


def _job_agent():
    """The tpurun WorkerAgent when this process is part of a job: the
    public API must reach the JOB-global name table (the HNP's server)
    there, not this process's local table, which no other worker
    sees."""
    from .runtime import Runtime

    rt = Runtime._instance
    return getattr(rt, "agent", None) if rt is not None else None


def publish_name(service: str, port: str) -> None:
    """``MPI_Publish_name`` (pubsub_orte: the HNP-hosted name table
    under tpurun, a process-local table otherwise)."""
    agent = _job_agent()
    if agent is not None:
        agent.publish_name(service, port)
        return
    with _local_cv:
        if service in _local_names:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"service '{service}' already published")
        _local_names[service] = port
        _local_cv.notify_all()


def unpublish_name(service: str) -> None:
    """``MPI_Unpublish_name``."""
    agent = _job_agent()
    if agent is not None:
        agent.unpublish_name(service)
        return
    with _local_cv:
        if _local_names.pop(service, None) is None:
            raise MPIError(ErrorCode.ERR_NAME,
                           f"service '{service}' not published")


def lookup_name(service: str, *, timeout_s: float = 10.0) -> str:
    """``MPI_Lookup_name``: blocks until the name is published or
    ``timeout_s`` passes (ERR_NAME)."""
    agent = _job_agent()
    if agent is not None:
        return agent.lookup_name(service,
                                 timeout_ms=int(timeout_s * 1000))
    deadline = time.monotonic() + timeout_s
    with _local_cv:
        while service not in _local_names:
            left = deadline - time.monotonic()
            if left <= 0:
                raise MPIError(ErrorCode.ERR_NAME,
                               f"lookup '{service}': not published "
                               f"within {timeout_s}s")
            _local_cv.wait(left)
        return _local_names[service]
