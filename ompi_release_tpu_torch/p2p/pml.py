"""Host PML — dynamic (rank, tag, comm) matching over device copies.

Counterpart of ``ompi_release_tpu/p2p/pml.py``, in-process half. The
ob1 engine's structure (``ompi/mca/pml/ob1/``) kept where it still
carries meaning with rank-stacked tensors on one controller:

- the matching machinery — per-(comm, rank) posted-recv queues and
  unexpected queues with MPI ordering and ANY_SOURCE/ANY_TAG wildcards
  (``pml_ob1_recvfrag.c:106,502,550`` match_one/unexpected);
- protocol selection by message size (``pml_ob1_sendreq.c:480,785``):
  eager = copy at send time; rendezvous = copy only when the matching
  recv posts (the receiver-side pull); pipelined = segmented copies for
  messages over the max-send size.

A "move" is a device copy on the payload's device: every payload is a
tensor on the communicator's device, so the copy stays on that device
(virtual ranks share one card). The size thresholds are those of the
JAX package's btl modules for an in-process pair
(``ompi_release_tpu/btl/components.py:299-355``): a self-send moves in
one shot at any size, another rank is eager up to 1 MiB and segments
beyond 64 MiB; ``pml_eager_limit`` / ``pml_max_send_size`` override
both, as there.

Tensors are mutable, unlike jax arrays, so buffer ownership follows MPI
and not the JAX package's "always reusable" shortcut: an ``isend``
buffer belongs to the engine until its request completes, and a
blocking standard ``send`` whose rendezvous is still pending snapshots
the buffer before it returns.

Communicators spanning ``tpurun`` worker processes get the
``WirePmlEngine``: pairs crossing a process boundary ride the runtime's
wire router, and wire arrivals are fed into the same matching queues.

A blocking wire receive parks in 100 ms slices and re-checks the ULFM
failure picture between them (``ft/ulfm``): a sender whose process the
job epoch marks failed, or a revoked comm, raises the typed error
within one slice instead of after ``pml_wire_timeout``. Message logging
(``p2p/vprotocol.py``) hooks in through ``_logger``: every send, wire
arrival, recv posting and matched probe is recorded under the matching
lock, so the log's order is the match order.

Observability: with obs on, a send posting, a recv posting and a
matched delivery are ``pml``-layer spans, PERUSE lifecycle events
(``peruse.py``) fire at the reference's points, and the stall watchdog
arms around a blocking wire receive and an ssend's ack wait.
"""

from __future__ import annotations

import collections
import threading
import time as _time
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..mca import component as mca_component
from ..mca import pvar
from ..mca import var as mca_var
from ..obs import watchdog as _watchdog
from ..request.request import Request, Status
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("pml")

ANY_SOURCE = -1
ANY_TAG = -1

#: btl thresholds of an in-process pair (see the module docstring)
SELF_LIMIT = 1 << 62
PEER_EAGER_LIMIT = 1 << 20
PEER_MAX_SEND_SIZE = 64 << 20

_unexpected_count = pvar.counter(
    "pml_unexpected_msgs", "sends queued before a matching recv was posted"
)
_eager_count = pvar.counter("pml_eager_sends", "eager-protocol sends")
_rndv_count = pvar.counter("pml_rndv_sends", "rendezvous-protocol sends")
_pipeline_count = pvar.counter(
    "pml_pipelined_sends", "segmented (pipelined) large sends"
)

PML_FRAMEWORK = mca_component.framework(
    "pml", "point-to-point management (ompi/mca/pml analogue)"
)


def _as_device_payload(data, device: torch.device) -> torch.Tensor:
    """A send payload as a tensor on ``device``. Structured, string or
    object data is refused with MPI's own answer: describe it with a
    datatype and pack it to a numeric buffer (the reference never sends
    raw C structs either — ``MPI_Type_struct`` + pack/unpack is the
    contract)."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    arr = np.array(data, order="C")  # a copy: keeps 0-d shapes 0-d
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch from_numpy
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if arr.dtype.kind not in "biufc":
        raise MPIError(
            ErrorCode.ERR_TYPE,
            f"p2p payload of type {type(data).__name__} is not a "
            "numeric array; describe structured/byte data with a "
            "datatype and pack it (ompi_release_tpu_torch.datatype."
            "Convertor) before sending, then unpack at the receiver "
            f"(dtype {arr.dtype} is not numeric)",
        )
    return torch.from_numpy(arr).to(device)


def register_vars() -> None:
    mca_var.register(
        "pml_eager_limit", "size", 0,
        "Override: messages up to this many bytes move at send time; "
        "0 = the pair's btl threshold (1 MiB, unlimited for a self-send)",
    )
    mca_var.register(
        "pml_max_send_size", "size", 0,
        "Override: messages beyond this many bytes move as segments; "
        "0 = the pair's btl threshold (64 MiB, unlimited for a self-send)",
    )
    mca_var.register(
        "pml_wire_timeout", "float", 30.0,
        "Seconds a blocking cross-process recv or ssend waits for its "
        "match before raising ERR_PENDING",
    )


class _SendEntry:
    """A send awaiting (or delivering to) its match."""

    __slots__ = ("src", "dst", "tag", "data", "request", "sync",
                 "transferred")

    def __init__(self, src, dst, tag, data, request, sync) -> None:
        self.src = src
        self.dst = dst
        self.tag = tag
        self.data = data
        self.request = request
        self.sync = sync  # ssend: complete only on match
        self.transferred = False


class _RecvEntry:
    __slots__ = ("dst", "source", "tag", "request")

    def __init__(self, dst, source, tag, request) -> None:
        self.dst = dst
        self.source = source
        self.tag = tag
        self.request = request


def _tag_match(posted_tag: int, tag: int) -> bool:
    return posted_tag == ANY_TAG or posted_tag == tag


def _nbytes(data: torch.Tensor) -> int:
    return data.numel() * data.element_size()


class PmlEngine:
    """Per-communicator matching engine (single controller: it sees all
    ranks' posts, so matching is a local queue operation; the reference
    does the same work after the wire delivers the MATCH header)."""

    def __init__(self, comm) -> None:
        self.comm = comm
        self._lock = threading.RLock()
        # per destination rank: unexpected sends (FIFO — MPI ordering)
        self._unexpected: Dict[int, Deque[_SendEntry]] = (
            collections.defaultdict(collections.deque)
        )
        # per destination rank: posted recvs (FIFO)
        self._posted: Dict[int, Deque[_RecvEntry]] = (
            collections.defaultdict(collections.deque)
        )
        self._logger = None  # vprotocol message log, when attached

    # -- helpers -----------------------------------------------------------
    def _purge_cancelled(self, dst: int) -> None:
        """Drop cancelled entries so they never match a live message
        (MPI_Cancel semantics: a cancelled recv must not consume a
        send, and vice versa)."""
        self._posted[dst] = collections.deque(
            r for r in self._posted[dst] if not r.request.is_cancelled
        )
        self._unexpected[dst] = collections.deque(
            s for s in self._unexpected[dst] if not s.request.is_cancelled
        )

    def _check_rank(self, r: int, what: str) -> None:
        if not 0 <= r < self.comm.size:
            raise MPIError(
                ErrorCode.ERR_RANK,
                f"{what} rank {r} out of range on {self.comm.name}",
            )

    def _eager_limit(self, src_rank: int, dst_rank: int) -> int:
        override = mca_var.get("pml_eager_limit", 0)
        if override:
            return int(override)
        return SELF_LIMIT if src_rank == dst_rank else PEER_EAGER_LIMIT

    def _move(self, data: torch.Tensor, src_rank: int,
              dst_rank: int) -> torch.Tensor:
        """Copy ``data`` for the receiver: one copy up to the max-send
        size, else max-send-sized segments copied one after another
        (``pml_pipelined_sends`` counts the segmented moves)."""
        seg = int(mca_var.get("pml_max_send_size", 0)) or (
            SELF_LIMIT if src_rank == dst_rank else PEER_MAX_SEND_SIZE)
        if data.dim() == 0 or _nbytes(data) <= seg:
            return data.clone(memory_format=torch.contiguous_format)
        _pipeline_count.add()
        flat = data.reshape(-1)
        out = torch.empty_like(flat)
        step = max(1, seg // data.element_size())
        for i in range(0, flat.numel(), step):
            out[i:i + step].copy_(flat[i:i + step])
        return out.view(data.shape)

    # -- send --------------------------------------------------------------
    def isend(self, data, dst: int, tag: int = 0, *, src: int,
              sync: bool = False, ready: bool = False) -> Request:
        """Nonblocking send from rank ``src`` to rank ``dst``.

        sync=True  -> ssend: completes only when matched.
        ready=True -> rsend: raises unless a matching recv is posted.
        """
        return self._post_send(data, dst, tag, src, sync, ready)[0]

    def _post_send(self, data, dst: int, tag: int, src: int, sync: bool,
                   ready: bool) -> Tuple[Request, _SendEntry]:
        self._check_rank(dst, "destination")
        self._check_rank(src, "source")
        data = _as_device_payload(data, self.comm.device)
        if _obs.enabled:  # instant emit point: the send posting itself
            _obs.record("isend", "pml", _time.perf_counter(), 0.0,
                        nbytes=_nbytes(data), peer=dst,
                        comm_id=self.comm.cid)
        req = Request()
        entry = _SendEntry(src, dst, tag, data, req, sync)
        from . import peruse

        peruse.fire(self.comm, peruse.REQ_ACTIVATE, kind="send",
                    src=src, dst=dst, tag=tag)
        with self._lock:
            if self._logger is not None:
                # logged UNDER the matching lock like recv postings:
                # the log's event order must equal the queue order or
                # replay swaps same-(src, tag) deliveries
                self._logger.record(src, dst, tag, data, sync)
            self._purge_cancelled(dst)
            posted = self._posted[dst]
            match = next(
                (r for r in posted
                 if (r.source in (ANY_SOURCE, src))
                 and _tag_match(r.tag, tag)),
                None,
            )
            if match is not None:
                posted.remove(match)
                self._deliver(entry, match)
                return req, entry
            if ready:
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"rsend with no posted recv (src={src} dst={dst} "
                    f"tag={tag})",
                )
            if _nbytes(data) <= self._eager_limit(src, dst):
                # eager: copy now; the sender side is complete at once
                _eager_count.add()
                entry.data = self._move(data, src, dst)
                entry.transferred = True
                if not sync:
                    req.complete(status=Status(source=src, tag=tag))
            else:
                # rendezvous: hold the buffer; the copy happens when the
                # matching recv posts
                _rndv_count.add()
            _unexpected_count.add()
            self._unexpected[dst].append(entry)
        peruse.fire(self.comm, peruse.MSG_UNEX_INSERT, src=src, dst=dst,
                    tag=tag)
        return req, entry

    def send(self, data, dst: int, tag: int = 0, *, src: int,
             sync: bool = False) -> None:
        """Blocking send. A standard send returns with the caller's
        buffer reusable and never waits for the match (one controller
        posts the matching recv later): a rendezvous still pending keeps
        a snapshot instead of the caller's tensor. Only ssend
        (sync=True) waits for the match, which in single-controller
        driver mode requires the recv to be posted already."""
        req, entry = self._post_send(data, dst, tag, src, sync, False)
        if sync:
            req.wait()
            return
        with self._lock:
            if not req.is_complete:
                entry.data = entry.data.clone()

    # -- recv --------------------------------------------------------------
    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
              dst: int) -> Request:
        """Nonblocking receive posted by rank ``dst``."""
        self._check_rank(dst, "destination")
        if source != ANY_SOURCE:
            self._check_rank(source, "source")
        if _obs.enabled:
            _obs.record("irecv", "pml", _time.perf_counter(), 0.0,
                        peer=source, comm_id=self.comm.cid)
        req = Request()
        entry = _RecvEntry(dst, source, tag, req)
        from . import peruse

        peruse.fire(self.comm, peruse.REQ_ACTIVATE, kind="recv",
                    src=source, dst=dst, tag=tag)
        with self._lock:
            if self._logger is not None:
                # pessimist determinant: logged UNDER the matching lock
                # so the event order equals the match order; the
                # matched (src, tag) is filled in at completion
                self._logger.record_recv_post(dst, source, tag, req)
            self._purge_cancelled(dst)
            unex = self._unexpected[dst]
            match = next(
                (s for s in unex
                 if (source in (ANY_SOURCE, s.src))
                 and _tag_match(tag, s.tag)),
                None,
            )
            if match is not None:
                unex.remove(match)
                peruse.fire(self.comm, peruse.REQ_MATCH_UNEX,
                            src=match.src, dst=dst, tag=match.tag)
                self._deliver(match, entry)
            else:
                self._posted[dst].append(entry)
        return req

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
             dst: int) -> Tuple[Any, Status]:
        req = self.irecv(source, tag, dst=dst)
        st = req.wait()
        return req.value, st

    # -- probe -------------------------------------------------------------
    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
               dst: int) -> Optional[Status]:
        """Nonblocking probe of the unexpected queue (MPI_Iprobe)."""
        with self._lock:
            self._purge_cancelled(dst)
            for s in self._unexpected[dst]:
                if (source in (ANY_SOURCE, s.src)) and _tag_match(tag, s.tag):
                    return Status(source=s.src, tag=s.tag,
                                  count=s.data.numel())
        return None

    # -- matched probe (MPI_Mprobe / MPI_Mrecv) ----------------------------
    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
                dst: int):
        """Nonblocking matched probe: removes the matched message from
        the unexpected queue and returns a message handle (so a later
        wildcard recv cannot steal it); None when nothing matches."""
        with self._lock:
            self._purge_cancelled(dst)
            unex = self._unexpected[dst]
            match = next(
                (s for s in unex
                 if (source in (ANY_SOURCE, s.src))
                 and _tag_match(tag, s.tag)),
                None,
            )
            if match is None:
                return None
            unex.remove(match)
            if self._logger is not None:
                # improbe IS the nondeterministic match decision the
                # pessimist log exists to capture
                self._logger.record_matched_recv(
                    dst, source, tag, match.src, match.tag)
            return match  # the message handle

    def mrecv(self, message: _SendEntry, *, dst: int):
        """Receive a message handle returned by improbe."""
        entry = _RecvEntry(dst, message.src, message.tag, Request())
        self._deliver(message, entry)
        return entry.request.value, entry.request.status

    def dump_queues(self, lock_timeout_s: float = 0.5) -> Dict[str, list]:
        """Debugger message-queue dump (the TotalView DLL contract,
        ``ompi/debuggers``): every pending send/recv with its match
        envelope. Lock acquisition is bounded: a thread wedged inside a
        match-lock critical section must not hang the dump."""
        if not self._lock.acquire(timeout=lock_timeout_s):
            return {"unexpected": [], "posted": [],
                    "error": "match lock held (a thread is wedged "
                             "inside the matching engine)"}
        try:
            for dst in set(self._unexpected) | set(self._posted):
                self._purge_cancelled(dst)
            return {
                "unexpected": [
                    {"src": s.src, "dst": s.dst, "tag": s.tag,
                     "bytes": _nbytes(s.data),
                     "protocol": "eager" if s.transferred else "rndv"}
                    for q in self._unexpected.values() for s in q
                ],
                "posted": [
                    {"dst": r.dst, "source": r.source, "tag": r.tag}
                    for q in self._posted.values() for r in q
                ],
            }
        finally:
            self._lock.release()

    # -- persistent --------------------------------------------------------
    def send_init(self, data, dst: int, tag: int = 0, *, src: int) -> Request:
        def start(req):
            inner = self.isend(data, dst, tag, src=src)
            inner.on_complete(
                lambda r: req.complete(status=r.status)
            )

        return Request(persistent_start=start)

    def recv_init(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
                  dst: int) -> Request:
        def start(req):
            inner = self.irecv(source, tag, dst=dst)
            inner.on_complete(
                lambda r: req.complete(value=r.value, status=r.status)
            )

        return Request(persistent_start=start)

    # -- delivery ----------------------------------------------------------
    def _deliver(self, send: _SendEntry, recv: _RecvEntry) -> None:
        from . import peruse

        rec = _obs.enabled  # capture once: flag may flip mid-delivery
        t0 = _time.perf_counter() if rec else 0.0
        data = send.data
        if not send.transferred:
            peruse.fire(self.comm, peruse.REQ_XFER_BEGIN, src=send.src,
                        dst=recv.dst, tag=send.tag)
            data = self._move(data, send.src, recv.dst)  # rendezvous pull
        st = Status(source=send.src, tag=send.tag, count=data.numel())
        recv.request.complete(value=data, status=st)
        send.request.complete(status=Status(source=send.src, tag=send.tag))
        peruse.fire(self.comm, peruse.REQ_XFER_END, src=send.src,
                    dst=recv.dst, tag=send.tag, count=data.numel())
        peruse.fire(self.comm, peruse.REQ_COMPLETE, src=send.src,
                    dst=recv.dst, tag=send.tag)
        if rec and _obs.enabled:  # matched delivery incl. rndv pull
            _obs.record("deliver", "pml", t0, _time.perf_counter() - t0,
                        nbytes=_nbytes(data), peer=send.src,
                        comm_id=self.comm.cid)
        _log.verbose(
            3,
            f"{self.comm.name}: delivered src={send.src} dst={send.dst} "
            f"tag={send.tag} n={data.numel()}",
        )

    # -- teardown ----------------------------------------------------------
    def pending_counts(self) -> Tuple[int, int]:
        with self._lock:
            for dst in set(self._unexpected) | set(self._posted):
                self._purge_cancelled(dst)
            return (
                sum(len(q) for q in self._unexpected.values()),
                sum(len(q) for q in self._posted.values()),
            )


class WirePmlEngine(PmlEngine):
    """PML for communicators spanning controller processes: local pairs
    use the in-process matching machinery unchanged; pairs crossing a
    process boundary ride the runtime's wire router (shm handoff on one
    host, DCN staging across hosts) — the ``btl/tcp``-under-ob1 role,
    with no caller-visible API difference (``btl_tcp_component.c:883``).

    Driver-mode contract: each process acts only as its LOCAL ranks —
    an isend must name a local ``src``, a recv a local ``dst``. Wire
    arrivals are pumped into the normal unexpected queues during
    recv/probe progress, so ordering, ANY_SOURCE/ANY_TAG and matched
    probes keep their MPI semantics across the boundary. A payload on
    the card is staged to the host with a blocking copy before it
    leaves, and an arrival is moved to the comm's device before it
    enters the queues.
    """

    def __init__(self, comm) -> None:
        super().__init__(comm)
        self._router = comm.runtime.wire
        self._local_set = set(comm.local_comm_ranks)

    def _require_local(self, rank: int, what: str) -> None:
        if rank not in self._local_set:
            owner = self._router.owner_of(self.comm.group.world_rank(rank))
            raise MPIError(
                ErrorCode.ERR_RANK,
                f"{what} rank {rank} on {self.comm.name} is owned by "
                f"process {owner}; each process acts only as its local "
                "ranks (the acting-rank driver convention)",
            )

    # -- send --------------------------------------------------------------
    def isend(self, data, dst: int, tag: int = 0, *, src: int,
              sync: bool = False, ready: bool = False) -> Request:
        self._check_rank(dst, "destination")
        self._check_rank(src, "source")
        self._require_local(src, "acting source")
        if dst in self._local_set:
            return super().isend(data, dst, tag, src=src, sync=sync,
                                 ready=ready)
        # cross-process: rsend legally degrades to a standard send (an
        # implementation MAY treat ready mode as standard; verifying
        # the remote posted-recv would cost a round trip). The payload
        # is on the host when send_p2p returns, so the caller's buffer
        # is reusable at once.
        data = _as_device_payload(data, self.comm.device)
        from . import peruse

        peruse.fire(self.comm, peruse.REQ_ACTIVATE, kind="send",
                    src=src, dst=dst, tag=tag)
        if self._logger is not None:
            with self._lock:
                self._logger.record(src, dst, tag, data, sync)
        seq = self._router.send_p2p(self.comm, src, dst, tag, data, sync)
        if not sync:
            req = Request()
            req.complete(status=Status(source=src, tag=tag))
            return req
        # ssend: completes when the receiver's match acks back
        router, cid = self._router, self.comm.cid
        src_world = self.comm.group.world_rank(src)

        def progress(r) -> None:
            router.poll_acks(src_world)
            if router.has_ack(cid, seq):
                router.take_ack(cid, seq)
                r.complete(status=Status(source=src, tag=tag))

        def block() -> None:
            tok = None
            if _watchdog.enabled:
                tok = _watchdog.arm(
                    "p2p_ssend_ack", comm_id=cid, peer=dst,
                    info={"src": src, "dst": dst, "tag": tag,
                          "seq": seq},
                )
            try:
                limit = float(mca_var.get("pml_wire_timeout", 30.0))
                deadline = _time.monotonic() + limit
                while _time.monotonic() < deadline:
                    router.poll_acks(src_world, timeout_ms=100)
                    if router.take_ack(cid, seq):
                        return
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"ssend to rank {dst} never matched (no ack within "
                    f"{limit}s; pml_wire_timeout raises the limit)",
                )
            finally:
                if tok is not None:
                    _watchdog.disarm(tok)

        req = Request(progress_fn=progress, block_fn=block)
        # the block() completion path reaches Request.wait()'s bare
        # complete(): pre-set the status so both completion paths
        # report the same (source, tag)
        req.status = Status(source=src, tag=tag)
        return req

    def send(self, data, dst: int, tag: int = 0, *, src: int,
             sync: bool = False) -> None:
        self._require_local(src, "acting source")
        if dst in self._local_set:
            super().send(data, dst, tag, src=src, sync=sync)
            return
        req = self.isend(data, dst, tag, src=src, sync=sync)
        if sync:
            req.wait()

    # -- recv --------------------------------------------------------------
    def _drain(self, dst: int, timeout_ms: int = 0) -> bool:
        return self._router.drain_p2p(
            self.comm.group.world_rank(dst), timeout_ms=max(1, timeout_ms)
        )

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
              dst: int) -> Request:
        self._check_rank(dst, "destination")
        self._require_local(dst, "receiving")
        may_cross = source == ANY_SOURCE or source not in self._local_set
        if may_cross:
            # pump anything already queued before posting, so an
            # earlier wire arrival matches in order
            while self._drain(dst):
                pass
        req = super().irecv(source, tag, dst=dst)
        if may_cross and not req.is_complete:
            engine = self

            def progress(r) -> None:
                engine._drain(dst)

            def block() -> None:
                from ..ft import ulfm as _ulfm
                from ..runtime.wire import proc_topology

                tok = None
                if _watchdog.enabled:
                    tok = _watchdog.arm(
                        "p2p_recv", comm_id=engine.comm.cid,
                        peer=source,
                        info={"source": source, "tag": tag, "dst": dst},
                    )
                try:
                    comm = engine.comm
                    if source == ANY_SOURCE:
                        ft_peers = list(proc_topology(comm).peers)
                    else:
                        ft_peers = [proc_topology(comm).owner[source]]
                    limit = float(mca_var.get("pml_wire_timeout", 30.0))
                    deadline = _time.monotonic() + limit
                    while (not req.is_complete
                           and _time.monotonic() < deadline):
                        # ULFM bound: a recv whose (possible) sender
                        # died — or whose comm was revoked — raises
                        # the typed error within one drain slice
                        _ulfm.state().check_wait(
                            comm.cid, ft_peers,
                            f"p2p recv(source={source}) awaiting",
                            epoch0=getattr(comm, "_ft_epoch0", 0))
                        engine._drain(dst, timeout_ms=100)
                    if not req.is_complete:
                        raise MPIError(
                            ErrorCode.ERR_PENDING,
                            f"recv(source={source}, tag={tag}) at rank "
                            f"{dst}: no matching message within "
                            f"{limit}s (pml_wire_timeout raises the "
                            "limit)",
                        )
                finally:
                    if tok is not None:
                        _watchdog.disarm(tok)

            req._progress_fn = progress
            req._block_fn = block
        return req

    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
               dst: int):
        self._require_local(dst, "probing")
        while self._drain(dst):
            pass
        return super().iprobe(source, tag, dst=dst)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG, *,
                dst: int):
        self._require_local(dst, "probing")
        while self._drain(dst):
            pass
        return super().improbe(source, tag, dst=dst)

    # -- wire delivery (called by the router's drain) ----------------------
    def _enqueue_wire(self, src_rank: int, dst_rank: int, user_tag: int,
                      data, on_matched=None) -> None:
        """Insert one wire arrival into the matching machinery exactly
        where a local eager send would land (payload already moved to
        this process's device, so the entry is 'transferred')."""
        from . import peruse

        data = data.to(self.comm.device)
        req = Request()
        if on_matched is not None:
            req.on_complete(on_matched)
        entry = _SendEntry(src_rank, dst_rank, user_tag, data, req, False)
        entry.transferred = True
        with self._lock:
            if self._logger is not None:
                # a wire arrival IS a send landing in this process's
                # queues: log it under the matching lock exactly like a
                # local isend, or replay would deliver fewer messages
                self._logger.record(src_rank, dst_rank, user_tag, data,
                                    False)
            self._purge_cancelled(dst_rank)
            posted = self._posted[dst_rank]
            match = next(
                (r for r in posted
                 if (r.source in (ANY_SOURCE, src_rank))
                 and _tag_match(r.tag, user_tag)),
                None,
            )
            if match is not None:
                posted.remove(match)
                self._deliver(entry, match)
                return
            _unexpected_count.add()
            self._unexpected[dst_rank].append(entry)
        peruse.fire(self.comm, peruse.MSG_UNEX_INSERT, src=src_rank,
                    dst=dst_rank, tag=user_tag)


class Ob1TpuComponent(mca_component.Component):
    """Default PML component ("ob1" kept as the name users know)."""

    NAME = "ob1"
    PRIORITY = 20

    def register_vars(self) -> None:
        register_vars()

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if getattr(ctx, "spans_processes", False):
            return (self.priority, WirePmlEngine(ctx))
        return (self.priority, PmlEngine(ctx))


PML_FRAMEWORK.register(Ob1TpuComponent())


def comm_select(comm) -> PmlEngine:
    """Install the per-comm PML engine (mca_pml_base_select analogue)."""
    avail = PML_FRAMEWORK.available(comm)
    if not avail:
        raise MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                       "no PML component available")
    _, comp, engine = avail[0]
    _log.verbose(2, f"{comm.name}: pml -> {comp.NAME}")
    return engine
