"""Cross-process data plane — the unified-COMM_WORLD wire router (the
port's counterpart of ``ompi_release_tpu/runtime/wire.py``).

The reference's core runtime promise is that after launch every rank
reaches every rank through one API: ``ompi_mpi_init.c:759-786`` calls
``add_procs`` over *all* peers, and an ``MPI_Send`` crosses nodes
through ``btl/tcp`` (``btl_tcp_component.c:883-893``) with no
caller-visible difference from shared memory. Under ``tpurun`` each
worker process owns only its local devices (its virtual ranks share
one card), so cross-process traffic cannot be a device copy — it
rides the honest transports, with the payload staged through host
memory (see ``btl/components.py``):
:class:`~..btl.components.ShmBtl` single-segment handoffs on the same
host, :class:`~..btl.components.DcnBtl` chunked OOB staging across
hosts. This router is the glue that lets the PML and the hierarchical
collectives use those transports *through the public API*:

- every worker holds a live OOB link to every peer (full wire-up runs
  during the ESS bootstrap, gated by the init barrier);
- p2p messages are an envelope frame (cid, src/dst comm ranks, user
  tag, sync flag, seq, delivery order) followed by the btl payload on
  a per-(destination, lane) channel tag — the receiving process drains
  its channels into the normal PML matching queues, so ordering and
  wildcards keep MPI semantics;
- collectives get per-communicator payload and control channels used
  by the ``hier`` coll component for the inter-process combine step.

**Pipelined wire transport** (the ob1 RNDV-pipeline role,
``pml_ob1_sendreq.c:785``): payloads above ``wire_pipeline_segsize``
cross as a stream of fixed-size fragments sliced straight off the
source buffer (memoryview, no monolithic ``tobytes()`` — see
``DcnBtl.staged_frames``), reassembled into a preallocated buffer at
each fragment's own offset on the receiver. ``wire_pipeline_segsize=0``
restores the exact legacy single-pass framing.

**Channel concurrency**: the old coarse ``("send", dst)`` /
``("drain", dst)`` locks serialized every tag behind one destination
stream — the head-of-line blocking the previous revision of this file
documented. Tags now hash onto ``wire_p2p_lanes`` per-destination
lanes, each with its own channel tag and lock, so independent tags and
comms no longer queue behind each other's large transfers. MPI's
non-overtaking rule survives lane reordering through a per-(sender
process, destination rank) delivery order stamped in the envelope: a
transfer may COMPLETE out of order, but messages enter the PML
matching queues in send order. ``wire_hol_wait_seconds`` times what is
left of the head-of-line wait.

Channel tags live far above ``USER_TAG_BASE`` so they can never shadow
the coordinator/pubsub control plane or hand-rolled staged transfers.

The native zero-copy datapath (``btl/nativewire``: shm rings between
co-hosted processes, vectored sockets across hosts) carries the payload
whenever both ends' modex cards advertise it (:meth:`_btl_for`); frozen
schedule plans send their rounds through :meth:`coll_send_planned`
(precomposed frame templates), and the progress engine's wire tick
(:meth:`coll_pump`) completes landed collective transfers ahead of the
round that reaps them.

ULFM bounded waits: every blocking wire wait (collective reaps,
peer-specific receives, ctl tokens) parks in ``_FT_SLICE_S`` slices
and re-checks the process-local failure picture (``ft/ulfm``) between
them, and every send checks it first, so a revoked cid raises
``ERR_REVOKED`` and a peer the job epoch marks failed for the comm
raises ``ERR_PROC_FAILED`` naming the process within one detection
interval, instead of the ``wire_coll_timeout_ms`` bound.

Observability: with obs on, a p2p transfer is a ``wire_send`` span and
a ``wire_recv`` span carrying the same ``("p2p", sender process,
seq)`` flow id (both already ride the envelope: no wire-format change),
the stall watchdog arms around the collective reap and the ctl-token
wait, and :meth:`WireRouter.sentinel_exchange` is the inline contract
sentinel's piggyback path. Not ported yet: the QoS lane classes of the
service plane (ROADMAP item 16b).

Thread model: driver-mode processes issue wire operations from the
main thread (plus completion threads polling acks and the nbc worker);
the ack set, sequence/order counters, reorder buffers, and the early
collective-transfer queue are lock-protected; payload channels rely on
the per-(src, tag) FIFO the OOB provides plus the shared stash in
``btl.components.stashed_recv``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..native import DssBuffer
from ..obs import watchdog as _watchdog
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("wire")

#: p2p envelope+payload channel: + lane stride + destination WORLD rank
WIRE_P2P_BASE = 1 << 20
#: ssend acknowledgements: + the original sender's WORLD rank
WIRE_ACK_BASE = 2 << 20
#: per-communicator collective payload channel: + cid
WIRE_COLL_BASE = 3 << 20
#: per-communicator collective control channel (barrier tokens): + cid
WIRE_CTL_BASE = 4 << 20

#: per-lane tag stride inside the p2p block: lane L of destination D is
#: ``WIRE_P2P_BASE + L * _LANE_STRIDE + D`` (lane 0 == the legacy tag)
_LANE_STRIDE = 1 << 17
_MAX_LANES = 8

_ENV_MAGIC = "WPM1"

#: sender time spent blocked behind another transfer's channel lock —
#: the head-of-line wait the per-(peer, tag-class) lanes exist to cut.
#: Module-level registration (the PR-1 zero-cost-counter class); the
#: uncontended path costs one try-acquire and never reads a clock.
_hol_wait = pvar.timer(
    "wire_hol_wait_seconds",
    "seconds senders spent waiting behind another transfer's wire "
    "channel lock (head-of-line wait)",
)

_coll_pumped = pvar.counter(
    "wire_coll_pumped",
    "collective transfers completed by the progress engine's wire "
    "pump (coll_pump) ahead of the round that reaps them",
)


#: bounded-wait slice: every blocking collective/ctl wait re-checks
#: the ULFM failure picture (revoked cid, known-failed peers) at this
#: period, so a dead peer turns a would-be indefinite hang into
#: ERR_PROC_FAILED within one detection interval
_FT_SLICE_S = 0.1


def _ft():
    """The process-local ULFM state."""
    from ..ft import ulfm

    return ulfm.STATE


def _ft_split_awaiting(procs) -> Dict[str, List[int]]:
    """Postmortem annotation: known-failed peers are NAMED as failed
    instead of listed as merely 'awaiting'."""
    procs = list(procs)
    dead = set(_ft().dead_for(procs))
    return {
        "awaiting_procs": sorted(q for q in procs if q not in dead),
        "known_failed_procs": sorted(dead),
    }


def register_vars() -> None:
    from ..btl.components import register_pipeline_vars

    register_pipeline_vars()  # wire_pipeline_segsize / _depth
    mca_var.register(
        "wire_p2p_lanes", "int", 4,
        "Per-destination p2p channel lanes; user tags hash onto lanes "
        "so independent tags no longer serialize behind one "
        "destination stream (1 = the legacy single channel)",
    )
    mca_var.register(
        "wire_overlap_exchange", "bool", True,
        "Reap spanning-comm exchange receives in arrival order "
        "(posted-sends overlap) instead of fixed process order; false "
        "restores the sequential per-peer receive loop",
    )
    mca_var.register(
        "wire_coll_timeout_ms", "int", 60_000,
        "Default bound in milliseconds for blocking collective/ctl "
        "wire waits (coll_recv, coll_recv_any, ctl_recv, barrier "
        "tokens). Compiled-schedule waits and chaos tests tune this; "
        "explicit per-call timeouts still win",
    )


register_vars()  # idempotent; cvars must exist before the first router


class WireTuning:
    """One immutable snapshot of the wire's hot-path cvars, resolved
    through the registry ONCE and stamped with the registry write
    generation. Per-message sends used to pay a registry lock + dict
    lookup each for ``wire_p2p_lanes`` / ``wire_pipeline_depth`` /
    ``wire_pipeline_segsize``; the router now reads attributes off the
    current snapshot and re-resolves only when the generation moved —
    so a mid-job cvar write takes effect at the next snapshot
    refresh."""

    __slots__ = ("gen", "lanes", "depth", "segsize", "coll_timeout_ms")

    def __init__(self) -> None:
        self.gen = mca_var.VARS.generation
        self.lanes = max(1, min(_MAX_LANES,
                                int(mca_var.get("wire_p2p_lanes", 4)
                                    or 1)))
        self.depth = max(1, int(mca_var.get("wire_pipeline_depth", 4)
                                or 1))
        self.segsize = int(mca_var.get("wire_pipeline_segsize", 0) or 0)
        self.coll_timeout_ms = int(
            mca_var.get("wire_coll_timeout_ms", 60_000) or 60_000)


class ProcTopology:
    """Process/member layout of a communicator under the unified
    world — ONE derivation shared by the hier collectives, the wire
    windows, and two-phase collective IO (each previously re-derived
    it; a change to ownership mapping must land exactly once)."""

    __slots__ = ("router", "my_pidx", "owner", "procs", "members_of",
                 "local_ranks", "local_n", "peers")

    def __init__(self, comm) -> None:
        rt = comm.runtime
        self.router: "WireRouter" = rt.wire
        self.my_pidx = int(rt.bootstrap["process_index"])
        n = comm.size
        self.owner: List[int] = [
            self.router.owner_of(comm.group.world_rank(i))
            for i in range(n)
        ]
        self.procs: List[int] = sorted(set(self.owner))
        self.members_of: Dict[int, List[int]] = {
            p: [i for i in range(n) if self.owner[i] == p]
            for p in self.procs
        }
        self.local_ranks: List[int] = list(comm.local_comm_ranks)
        self.local_n = len(self.local_ranks)
        self.peers: List[int] = [p for p in self.procs
                                 if p != self.my_pidx]


def proc_topology(comm) -> ProcTopology:
    """Cached per-communicator topology (the derivation is O(size x
    procs) owner-span scans — pay it once per comm)."""
    topo = getattr(comm, "_proc_topology", None)
    if topo is None:
        topo = comm._proc_topology = ProcTopology(comm)
    return topo


class WireRouter:
    """Per-runtime cross-process router over the worker's OOB endpoint."""

    def __init__(self, runtime) -> None:
        from ..btl.components import DcnBtl, ShmBtl

        self.rt = runtime
        self.agent = runtime.agent
        self.ep = self.agent.ep
        self.cards: List[Dict[str, Any]] = runtime.bootstrap["peer_cards"]
        self.my_pidx: int = runtime.bootstrap["process_index"]
        # rank spans: process p owns world ranks [offset, offset+count)
        self.spans: List[Tuple[int, int]] = runtime.proc_spans
        self._shm = ShmBtl()
        self._dcn = DcnBtl()
        # the zero-copy native datapath (btl/nativewire): None when the
        # native library lacks the wire_*/shmring_* symbols or the
        # component is disabled — every routing site below then falls
        # back to the portable shm/dcn transports structurally
        from ..btl import nativewire as _nativewire

        self._nw = _nativewire.module_for(self.cards, self.my_pidx)
        self._seq = itertools.count(1)
        self._acks: set = set()
        self._ack_lock = threading.Lock()
        # per-channel locks, keyed ("send"|"drain", (dst_world, lane))
        # or ("deliver", dst_world): an envelope and its payload must
        # land back-to-back on one lane FIFO (send side) and be popped
        # as a unit (drain side) — concurrent threads on ONE lane would
        # interleave frames and corrupt the stream. Distinct lanes are
        # independent: that is the whole point.
        self._chan_locks: Dict[Tuple[str, Any], threading.Lock] = {}
        self._chan_guard = threading.Lock()
        # per-destination delivery order (sender side) and the
        # receiver's reorder state: completed-but-early messages wait
        # in _rx_hold until every lower-order message delivered, so
        # lane concurrency can never reorder PML matching
        self._order: Dict[int, int] = {}
        self._order_lock = threading.Lock()
        self._rx_hold: Dict[Tuple[int, int], Dict[int, tuple]] = {}
        self._rx_next: Dict[Tuple[int, int], int] = {}
        self._rx_lock = threading.Lock()
        # rotating first-lane offset per destination: a 1 ms
        # nonblocking poll pumps at most one lane, so successive polls
        # must start at different lanes or lanes past 0 would starve
        # (benign races: worst case two polls share a start lane)
        self._drain_rr: Dict[int, int] = {}
        # collective transfers completed by an any-source reap before
        # their round asked for them (a peer racing one round ahead):
        # (cid, src_pidx) -> FIFO of arrays
        self._coll_early: Dict[Tuple[int, int], List] = {}
        self._coll_early_lock = threading.Lock()
        #: cids whose progress-engine pump hit a mid-transfer failure:
        #: the channel stream is unrecoverable, so pumps stand down and
        #: the round's own reap surfaces the loud error
        self._pump_dead: set = set()
        #: per-cid pump backoff: an empty pump probe costs a ~1 ms
        #: blocking OOB recv (ep.pending() counts frames on EVERY tag,
        #: so unrelated p2p traffic defeats the cheap fast path) —
        #: after an empty probe the pump skips this cid briefly so a
        #: busy endpoint cannot turn the progress thread into a
        #: continuous blocking-recv loop
        self._pump_idle: Dict[int, float] = {}
        #: hot-path cvars resolved once at init (satellite of the
        #: compiled-schedule PR): refreshed only when the registry
        #: write generation moves — see WireTuning
        self._tuning = WireTuning()

    def tuning(self) -> WireTuning:
        """Current wire-tuning snapshot (generation-checked: one int
        compare on the hot path; a cvar write re-resolves lazily)."""
        t = self._tuning
        if t.gen != mca_var.VARS.generation:
            t = self._tuning = WireTuning()
        return t

    def refresh_tuning(self) -> WireTuning:
        """Force a fresh snapshot NOW (plan-freeze entry: a frozen
        schedule plan must capture post-write values even if the
        generation bookkeeping ever lagged)."""
        t = self._tuning = WireTuning()
        return t

    def _chan_lock(self, kind: str, key) -> threading.Lock:
        with self._chan_guard:
            lk = self._chan_locks.get((kind, key))
            if lk is None:
                lk = self._chan_locks[(kind, key)] = threading.Lock()
            return lk

    # -- identity ----------------------------------------------------------
    @staticmethod
    def _nid(pidx: int) -> int:
        return pidx + 1  # worker node ids are 1-based (0 is the HNP)

    def owner_of(self, world_rank: int) -> int:
        for p, (off, cnt) in enumerate(self.spans):
            if off <= world_rank < off + cnt:
                return p
        raise MPIError(ErrorCode.ERR_RANK,
                       f"world rank {world_rank} outside every span")

    def _btl_for(self, peer_pidx: int):
        """Transport choice, deterministic on BOTH sides: when both
        ends' modex cards advertise the native datapath, nativewire
        carries the payload (shm rings co-hosted, vectored sockets
        cross-host); otherwise same machine (modex card host identity)
        -> shm handoff, else DCN staging — exactly the per-peer
        eligibility add_procs computes from business cards
        (``btl.h:810-816``)."""
        nw = self._nw
        if nw is not None and nw.peer_capable(peer_pidx):
            return nw
        same_host = (
            self.cards[self.my_pidx].get("host")
            and self.cards[self.my_pidx].get("host")
            == self.cards[peer_pidx].get("host")
        )
        return self._shm if same_host else self._dcn

    # -- lanes -------------------------------------------------------------
    def _lane_of(self, user_tag: int, comm=None) -> int:
        """THE lane-selection rule (single definition — send and any
        future drain/debug site must agree), reading the
        generation-cached ``tuning()`` snapshot, never the registry."""
        return int(user_tag) % self.tuning().lanes

    @staticmethod
    def _p2p_tag(dst_world: int, lane: int) -> int:
        if dst_world >= _LANE_STRIDE:
            raise MPIError(
                ErrorCode.ERR_INTERN,
                f"world rank {dst_world} exceeds the per-lane wire tag "
                f"space ({_LANE_STRIDE})",
            )
        return WIRE_P2P_BASE + lane * _LANE_STRIDE + dst_world

    # -- payload channel ---------------------------------------------------
    def _retry(self, fn, what: str, peer: Optional[int] = None,
               epoch0: int = 0):
        """First contact over an accepted fd can race the peer's
        announce processing on our reader thread (the same window
        recv_xcast retries around) — back off briefly before treating
        the link as dead. A peer the job epoch marks FAILED is not
        retried: the send fails fast with ERR_PROC_FAILED instead of
        burning the whole backoff against a corpse."""
        last = None
        for attempt in range(5):
            if peer is not None and attempt:
                _ft().check_peer(peer, what, epoch0)
            try:
                return fn()
            except MPIError as e:
                if e.code == ErrorCode.ERR_PROC_FAILED:
                    raise  # a confirmed process failure is not transient
                last = e
                time.sleep(0.05 * (attempt + 1))
        if peer is not None:
            _ft().check_peer(peer, what, epoch0)
        raise MPIError(ErrorCode.ERR_UNREACH,
                       f"{what} failed after retries: {last}")

    def _send_payload(self, peer_pidx: int, tag: int, arr,
                      epoch0: int = 0) -> None:
        """One payload (a tensor — on the card or the host — or a numpy
        array) to ``peer_pidx``; the btl stages a card tensor through
        host memory with a blocking copy."""
        btl = self._btl_for(peer_pidx)
        host = arr
        if btl is self._shm:
            self._retry(
                lambda: btl.send_shm(self.ep, self._nid(peer_pidx), tag,
                                     host),
                f"shm handoff to process {peer_pidx}",
                peer=peer_pidx, epoch0=epoch0,
            )
        else:
            self._retry(
                lambda: btl.send_staged(self.ep, self._nid(peer_pidx),
                                        tag, host),
                f"staged transfer to process {peer_pidx}",
                peer=peer_pidx, epoch0=epoch0,
            )

    def _recv_payload(self, tag: int, src_pidx: int,
                      timeout_ms: int = 30_000):
        btl = self._btl_for(src_pidx)
        if btl is self._shm:
            return btl.recv_shm(self.ep, tag, src=self._nid(src_pidx),
                                timeout_ms=timeout_ms)
        return btl.recv_staged(self.ep, tag, src=self._nid(src_pidx),
                               timeout_ms=timeout_ms)

    # -- p2p (the PML's cross-process route) -------------------------------
    def _next_order(self, dst_world: int) -> int:
        with self._order_lock:
            n = self._order.get(dst_world, 0) + 1
            self._order[dst_world] = n
            return n

    def send_p2p(self, comm, src_rank: int, dst_rank: int, user_tag: int,
                 data, sync: bool) -> int:
        """Envelope + payload to the process owning ``dst_rank``.
        Ranks in the envelope are COMM-local (matching happens against
        the destination comm's queues); the channel is keyed by the
        destination's WORLD rank plus the user tag's lane, so
        independent tags ride independent streams while every comm
        still shares the per-destination delivery order."""
        dst_world = comm.group.world_rank(dst_rank)
        peer = self.owner_of(dst_world)
        epoch0 = getattr(comm, "_ft_epoch0", 0)
        _ft().check_wait(comm.cid, (peer,), "p2p send", epoch0=epoch0)
        seq = next(self._seq)
        lane = self._lane_of(user_tag, comm)
        tag = self._p2p_tag(dst_world, lane)
        rec = _obs.enabled  # capture once: flag may flip mid-send
        t0 = time.perf_counter() if rec else 0.0
        lock = self._chan_lock("send", (dst_world, lane))
        if not lock.acquire(blocking=False):
            # contended: another transfer owns this lane — time the
            # head-of-line wait (the uncontended path never reads a
            # clock, keeping the off-cost at one try-acquire)
            w0 = time.perf_counter()
            lock.acquire()
            _hol_wait.add(time.perf_counter() - w0)
        try:
            # order allocation and the envelope send are one atomic
            # step per destination: if the envelope never reaches the
            # wire, the slot is rolled back under the same lock, so a
            # failed send can never leave a permanent gap that strands
            # every later message in the receiver's reorder hold.
            # Envelopes are single small frames — cross-lane payloads
            # (the actual bytes) still stream concurrently below.
            with self._chan_lock("order", dst_world):
                order = self._next_order(dst_world)
                env = DssBuffer()
                env.pack_string(_ENV_MAGIC)
                env.pack_int64([comm.cid, src_rank, dst_rank,
                                int(user_tag), 1 if sync else 0, seq,
                                order])
                try:
                    self._retry(
                        lambda: self.ep.send(self._nid(peer), tag,
                                             env.tobytes()),
                        f"p2p envelope to process {peer}",
                    )
                except MPIError:
                    with self._order_lock:
                        # safe: no other thread can have allocated a
                        # later slot while we hold the order chan lock
                        self._order[dst_world] = order - 1
                    raise
            self._send_payload(peer, tag, data, epoch0=epoch0)
        finally:
            lock.release()
        if rec and _obs.enabled:
            from ..btl.components import payload_nbytes

            # flow id from (sender process, wire seq) — both already
            # ride the envelope, so the receiver derives the SAME id
            # with no wire-format change (the trace-context contract)
            _obs.record("wire_send", "wire", t0,
                        time.perf_counter() - t0,
                        nbytes=payload_nbytes(data), peer=dst_world,
                        comm_id=comm.cid,
                        flow=_obs.flow_id("p2p", self.my_pidx, seq),
                        flow_side="s")
        return seq

    def drain_p2p(self, dst_world_rank: int, timeout_ms: int = 50) -> bool:
        """Receive wire traffic destined to ``dst_world_rank`` and push
        completed messages into the owning communicator's PML matching
        queues, in per-sender send order. Returns True if at least one
        message was delivered.

        ``timeout_ms`` bounds only the wait for ENVELOPES; once one is
        popped, its payload is consumed to completion — the sender
        wrote it immediately behind the envelope on the same lane FIFO,
        so the stall is bounded by the in-flight transfer, not by user
        behavior (head-of-line now scoped to ONE lane: other tags'
        lanes stay drainable, by this thread on its next sweep or by a
        concurrent thread — busy lanes are skipped, never waited on).
        A sender dying between envelope and payload surfaces as a loud
        ERR_TRUNCATE here, never a silently dropped message.
        """
        if self._deliver_ready(dst_world_rank):
            return True
        # cheap empty-channel fast path for nonblocking progress
        # (imprecise: pending() counts frames on every tag, so other
        # traffic forces the short recv below — never misses a frame)
        if timeout_ms <= 1 and self.ep.pending() == 0:
            return False
        deadline = time.monotonic() + timeout_ms / 1000
        nlanes = self.tuning().lanes
        # lanes beyond the local cvar get ONE cheap probe per blocking
        # drain call: a sender configured with MORE lanes
        # (heterogeneous MCA env, or the cvar flipped mid-flight) must
        # never have its messages stranded on a tag we refuse to poll —
        # but the mismatch path must not tax every sweep either
        probe_extras = timeout_ms > 1 and nlanes < _MAX_LANES
        start = self._drain_rr.get(dst_world_rank, 0) % max(nlanes, 1)
        self._drain_rr[dst_world_rank] = start + 1
        first_sweep = True
        while True:
            pumped_any = False
            for i in range(_MAX_LANES):
                # rotate only the first sweep's order; later sweeps
                # are inside a blocking wait and cover every lane
                lane = (start + i) % nlanes if (first_sweep
                                                and i < nlanes) else i
                local = lane < nlanes
                if not local and not probe_extras:
                    continue
                if pumped_any and time.monotonic() >= deadline:
                    break  # bound nonblocking polls at ~one lane pump
                lk = self._chan_lock("drain", (dst_world_rank, lane))
                if not lk.acquire(blocking=False):
                    continue  # another thread is pumping this lane
                try:
                    pumped_any = True
                    left = deadline - time.monotonic()
                    # short per-lane envelope wait so one silent lane
                    # cannot eat the whole budget when others have
                    # frames queued; a single lane gets the full wait;
                    # extra (mismatch-tolerance) lanes get the minimum
                    if not local:
                        per = 0.001
                    elif nlanes == 1:
                        per = left
                    else:
                        per = min(left, 0.01)
                    self._pump_lane(dst_world_rank, lane,
                                    time.monotonic() + max(per, 0.001))
                finally:
                    lk.release()
                if self._deliver_ready(dst_world_rank):
                    return True
            probe_extras = False  # once per call is tolerance enough
            first_sweep = False
            if time.monotonic() >= deadline:
                return False
            if not pumped_any:
                # every lane is owned by another thread: yield instead
                # of spinning on try-acquires until the deadline
                time.sleep(0.001)

    def _pump_lane(self, dst_world: int, lane: int,
                   deadline: float) -> bool:
        """Pop one envelope (+ its payload, to completion) off one lane
        and park the completed message in the reorder buffer. Returns
        True if a frame was consumed. Caller holds the lane's drain
        lock."""
        from ..btl.components import stashed_recv

        tag = self._p2p_tag(dst_world, lane)
        try:
            src_nid, raw = stashed_recv(self.ep, None, tag, deadline)
        except MPIError:
            return False  # nothing pending within the timeout
        env = DssBuffer(raw)
        if env.unpack_string() != _ENV_MAGIC:
            _log.verbose(1, f"dropping non-envelope frame on p2p "
                            f"channel {tag}")
            return True
        cid, src_rank, dst_rank, user_tag, sync, seq, order = \
            env.unpack_int64(7)
        src_pidx = src_nid - 1
        rec = _obs.enabled  # capture once: flag may flip mid-recv
        t0 = time.perf_counter() if rec else 0.0
        try:
            data = self._recv_payload(tag, src_pidx)
        except MPIError as e:
            if e.code == ErrorCode.ERR_PROC_FAILED:
                # the transport already issued the typed ULFM verdict
                # (the shm ring's pid-liveness check is authoritative
                # on one host) — recovery policies key on the code, so
                # it must not be laundered into a generic truncation
                raise
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                f"wire message from process {src_pidx} (comm cid "
                f"{cid}, src rank {src_rank}, tag {user_tag}) "
                "announced by its envelope but the payload never "
                f"completed — peer died mid-transfer? ({e})",
            )
        if rec and _obs.enabled:
            from ..btl.components import payload_nbytes

            # the matching consumer span: same (sender process, seq)
            # flow id the sender stamped — tpu-doctor draws the arrow
            _obs.record("wire_recv", "wire", t0,
                        time.perf_counter() - t0,
                        nbytes=payload_nbytes(data),
                        peer=int(src_rank), comm_id=int(cid),
                        flow=_obs.flow_id("p2p", src_pidx, int(seq)),
                        flow_side="t")
        with self._rx_lock:
            self._rx_hold.setdefault((src_pidx, dst_world), {})[
                int(order)] = (int(cid), int(src_rank), int(dst_rank),
                               int(user_tag), int(sync), int(seq),
                               src_pidx, data)
        return True

    def _deliver_ready(self, dst_world: int) -> bool:
        """Deliver every reorder-buffer message whose per-sender order
        is next-expected. The deliver lock serializes PML insertion per
        destination so two drain threads can never swap send order."""
        if not self._rx_hold:  # racy-but-safe fast path (dict bool)
            return False
        delivered = False
        with self._chan_lock("deliver", dst_world):
            while True:
                ready = None
                with self._rx_lock:
                    for key in list(self._rx_hold):
                        if key[1] != dst_world:
                            continue
                        nxt = self._rx_next.get(key, 1)
                        hold = self._rx_hold[key]
                        if nxt in hold:
                            ready = hold.pop(nxt)
                            self._rx_next[key] = nxt + 1
                            if not hold:
                                del self._rx_hold[key]
                            break
                if ready is None:
                    return delivered
                self._deliver_one(ready)
                delivered = True

    def _deliver_one(self, msg: tuple) -> None:
        from ..comm.communicator import _comm_registry

        cid, src_rank, dst_rank, user_tag, sync, seq, src_pidx, data = msg
        comm = _comm_registry.get(int(cid))
        if comm is None:
            raise MPIError(
                ErrorCode.ERR_COMM,
                f"wire message for unknown cid {cid} (communicator "
                "creation order diverged across processes?)",
            )
        on_matched = None
        if sync:
            src_world = comm.group.world_rank(int(src_rank))

            def on_matched(_req, _p=src_pidx, _c=int(cid), _s=int(seq),
                           _w=src_world):
                self.send_ack(_p, _c, _s, _w)

        comm.pml._enqueue_wire(int(src_rank), int(dst_rank),
                               int(user_tag), data, on_matched=on_matched)

    # -- ssend acknowledgements --------------------------------------------
    def send_ack(self, peer_pidx: int, cid: int, seq: int,
                 sender_world_rank: int) -> None:
        b = DssBuffer()
        b.pack_int64([cid, seq])
        self._retry(
            lambda: self.ep.send(self._nid(peer_pidx),
                                 WIRE_ACK_BASE + sender_world_rank,
                                 b.tobytes()),
            f"ssend ack to process {peer_pidx}",
        )

    def poll_acks(self, sender_world_rank: int,
                  timeout_ms: int = 0) -> None:
        """Drain every available ack addressed to ``sender_world_rank``
        into the ack set (timeout_ms=0: near-nonblocking — an empty
        endpoint returns immediately via the pending() fast path; with
        unrelated frames queued the probe costs ~1 ms)."""
        tag = WIRE_ACK_BASE + sender_world_rank
        if timeout_ms <= 0 and self.ep.pending() == 0:
            return
        while True:
            try:
                _, _, raw = self.ep.recv(tag=tag,
                                         timeout_ms=max(1, timeout_ms))
            except MPIError:
                return
            cid, seq = DssBuffer(raw).unpack_int64(2)
            with self._ack_lock:
                self._acks.add((int(cid), int(seq)))
            timeout_ms = 0  # only the first recv may wait

    def has_ack(self, cid: int, seq: int) -> bool:
        with self._ack_lock:
            return (cid, seq) in self._acks

    def take_ack(self, cid: int, seq: int) -> bool:
        with self._ack_lock:
            if (cid, seq) in self._acks:
                self._acks.discard((cid, seq))
                return True
            return False

    # -- collective channels (used by the hier coll component) -------------
    @staticmethod
    def _coll_tag(comm) -> int:
        if comm.cid >= (1 << 20):
            raise MPIError(ErrorCode.ERR_INTERN,
                           f"cid {comm.cid} exceeds the wire tag space")
        return WIRE_COLL_BASE + comm.cid

    def _coll_early_pop(self, cid: int, src_pidx: int):
        with self._coll_early_lock:
            q = self._coll_early.get((cid, src_pidx))
            if q:
                arr = q.pop(0)
                if not q:
                    del self._coll_early[(cid, src_pidx)]
                return arr
        return None

    def coll_send(self, comm, peer_pidx: int, arr) -> None:
        epoch0 = getattr(comm, "_ft_epoch0", 0)
        _ft().check_wait(comm.cid, (peer_pidx,), "collective send",
                         epoch0=epoch0)
        self._send_payload(peer_pidx, self._coll_tag(comm), arr,
                           epoch0=epoch0)

    def coll_recv(self, comm, src_pidx: int,
                  timeout_ms: Optional[int] = None):
        early = self._coll_early_pop(comm.cid, src_pidx)
        if early is not None:
            return early
        if timeout_ms is None:  # wire_coll_timeout_ms cvar (tunable)
            timeout_ms = self.tuning().coll_timeout_ms
        # serialize the comm's receivers: two threads popping frames of
        # ONE multi-frame transfer would split it. The caller's timeout
        # budget covers the lock wait too.
        deadline = time.monotonic() + timeout_ms / 1000
        tag = self._coll_tag(comm)
        lk = self._chan_lock("collrx", comm.cid)
        if not lk.acquire(timeout=max(0.001,
                                      deadline - time.monotonic())):
            raise MPIError(
                ErrorCode.ERR_PENDING,
                f"collective receive from process {src_pidx} timed out "
                "waiting for the comm's wire channel (held by another "
                "reap)",
            )
        try:
            early = self._coll_early_pop(comm.cid, src_pidx)
            if early is not None:
                return early
            # bounded-slice wait for the FIRST frame; once one
            # landed, the transfer is committed to completion against
            # the caller's full deadline
            _, raw = self._sliced_recv(
                self._nid(src_pidx), tag, deadline, comm,
                lambda: (src_pidx,), "collective receive from",
                f"collective receive from process {src_pidx} timed "
                f"out after {timeout_ms} ms")
            return self._finish_checked(
                src_pidx, tag, raw, deadline,
                epoch0=getattr(comm, "_ft_epoch0", 0))
        finally:
            lk.release()

    def coll_pump(self, comm, budget: int = 8) -> int:
        """Nonblocking receive-side progress on ``comm``'s collective
        payload channel — the progress engine's wire tick: complete up
        to ``budget`` landed transfers into the early-transfer queue so
        the round's reap (or the round that raced ahead) finds them
        without parking. Skips out instantly when the endpoint is idle
        or a reap already owns the channel (a parked reap IS the
        progress for that channel). A pump only STARTS on a transfer
        whose first frame already landed; it may then ride out the
        transfer's in-flight tail (bounded by the sender's streaming —
        the opal_progress discipline: completing in-flight fragments
        IS the progress). A transfer that FAILS mid-pump (peer died)
        leaves the channel stream unrecoverable for any consumer, so
        the pump marks this cid poisoned and stands down — the round's
        own reap surfaces the loud ERR_TRUNCATE instead of every tick
        re-paying the timeout. The channel lock is held per TRANSFER,
        not across the whole budget, so a reap arriving mid-pump
        queues behind at most one in-flight tail."""
        from ..btl.components import stashed_recv

        if comm.cid in self._pump_dead or self.ep.pending() == 0:
            return 0
        if time.monotonic() < self._pump_idle.get(comm.cid, 0.0):
            return 0  # recent empty probe: let the backoff expire
        tag = self._coll_tag(comm)
        lk = self._chan_lock("collrx", comm.cid)
        n = 0
        while n < budget:
            if not lk.acquire(blocking=False):
                return n  # a reap owns the channel: it IS the progress
            try:
                try:
                    src_nid, raw = stashed_recv(
                        self.ep, None, tag, time.monotonic() + 0.001)
                except MPIError:
                    if n == 0:
                        self._pump_idle[comm.cid] = \
                            time.monotonic() + 0.005
                    return n  # nothing pending on this channel
                src = src_nid - 1
                try:
                    # the finish budget matches the reaps' 60 s default
                    # deliberately: a SHORTER pump deadline would strand
                    # the popped frames and fail a transfer the round's
                    # own reap budget would have absorbed
                    arr = self._finish_transfer(
                        src, tag, raw, time.monotonic() + 60.0)
                except MPIError:
                    self._pump_dead.add(comm.cid)
                    raise
                with self._coll_early_lock:
                    self._coll_early.setdefault(
                        (comm.cid, src), []).append(arr)
                _coll_pumped.add()
                n += 1
            finally:
                lk.release()
        return n

    def _peer_frames(self, peer: int, tag: int, arrs: List,
                     epoch0: int = 0, templates=None):
        """Side-effecting generator: each ``next()`` puts ONE wire
        frame of this peer's transfer queue on the OOB. DCN transfers
        above the pipeline segsize stream as fragments sliced off the
        host copy; shm handoffs and legacy/small transfers count as
        one frame. ``templates`` (a frozen plan's per-array
        FrameTemplates, None entries = generic path) selects the
        precomposed-header send: no per-message cvar read or header
        packing."""
        btl = self._btl_for(peer)
        nid = self._nid(peer)
        for k, a in enumerate(arrs):
            tpl = templates[k] if templates is not None else None
            if btl is self._nw and btl is not None:
                # native datapath: the stream does its own sends (ring
                # writev / vectored sockets) with its own retry + typed
                # fault mapping; frames and yields stay 1:1 with the
                # portable stream so striping sees the same shape
                for _ in btl.frame_stream(self.ep, peer, tag, a,
                                          tpl=tpl):
                    yield
                continue
            if tpl is not None and btl is self._dcn:
                for frame in self._dcn.planned_frames(a, tpl):
                    self._retry(
                        lambda f=frame: self.ep.send(nid, tag, f),
                        f"pipelined fragment to process {peer}",
                    )
                    yield
                continue
            seg = self._dcn.pipeline_segsize() if btl is self._dcn else 0
            if seg > 0:
                # pvar accounting happens inside staged_frames — the
                # one place that knows frames (shared with send_staged)
                for frame in self._dcn.staged_frames(a, segsize=seg):
                    self._retry(
                        lambda f=frame: self.ep.send(nid, tag, f),
                        f"pipelined fragment to process {peer}",
                    )
                    yield
            else:
                self._send_payload(peer, tag, a, epoch0=epoch0)
                yield

    def coll_send_all(self, comm, arrs_for: Dict[int, List]) -> None:
        """Post one exchange round's sends to EVERY peer, striping
        pipelined fragments round-robin across destinations in
        ``wire_pipeline_depth``-sized bursts — every peer's receive
        side starts reassembling while the round is still being sent,
        instead of peer P+1 waiting for peer P's full payload."""
        tag = self._coll_tag(comm)
        epoch0 = getattr(comm, "_ft_epoch0", 0)
        streams = [self._peer_frames(p, tag, arrs_for[p], epoch0)
                   for p in sorted(arrs_for) if arrs_for[p]]
        self._stripe(streams, self.tuning().depth)

    def coll_send_planned(self, comm, rnd, sends: Dict[int, List]) -> None:
        """Steady-state round send from a frozen schedule plan
        (:mod:`coll.plan`): the round's peer list, per-peer templates
        (precomposed SGH2 headers + fragment offsets), striping depth
        and channel tag were all resolved at plan time — this path
        does ONE ULFM check for the round and then streams memoryview
        slices behind precomposed header bytes. Same frames, same
        striping discipline, same FIFO-per-peer ordering as
        :meth:`coll_send_all`."""
        epoch0 = getattr(comm, "_ft_epoch0", 0)
        _ft().check_wait(comm.cid, rnd.peers, "collective send",
                         epoch0=epoch0)
        streams = [
            self._peer_frames(p, rnd.tag, sends[p], epoch0,
                              templates=tpls)
            for p, tpls in rnd.peer_slots
        ]
        self._stripe(streams, rnd.depth)

    @staticmethod
    def _stripe(streams: List, depth: int) -> None:
        """Round-robin the per-peer frame generators in depth-sized
        bursts (the sliding in-flight window)."""
        while streams:
            keep = []
            for it in streams:
                alive = True
                for _ in range(depth):
                    try:
                        next(it)
                    except StopIteration:
                        alive = False
                        break
                if alive:
                    keep.append(it)
            streams = keep

    def coll_recv_any(self, comm, pending: Dict[int, int],
                      timeout_ms: Optional[int] = None):
        """Complete the NEXT transfer on ``comm``'s payload channel
        from whichever peer's frames arrive first; returns
        ``(src_pidx, array)``. ``pending`` maps peer -> messages still
        expected this round; a completed transfer from a peer with no
        outstanding count belongs to a FUTURE round (that peer raced
        ahead) and is queued for its own round's receive instead of
        being returned out of context. The default wait bound is the
        ``wire_coll_timeout_ms`` cvar."""
        if timeout_ms is None:
            timeout_ms = self.tuning().coll_timeout_ms
        for p in list(pending):
            if pending.get(p, 0) > 0:
                early = self._coll_early_pop(comm.cid, p)
                if early is not None:
                    return p, early
        tag = self._coll_tag(comm)
        deadline = time.monotonic() + timeout_ms / 1000
        tok = None
        if _watchdog.enabled:
            tok = _watchdog.arm(
                "coll_recv_any", comm_id=comm.cid,
                info=lambda p=pending: _ft_split_awaiting(
                    q for q, c in p.items() if c > 0),
            )
        # serialize the comm's receivers (two consumers popping frames
        # of one multi-frame transfer would split it); the lock wait is
        # bounded by the caller's deadline
        lk = self._chan_lock("collrx", comm.cid)
        try:
            if not lk.acquire(timeout=max(0.001,
                                          deadline - time.monotonic())):
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"collective any-source receive on {comm.name} "
                    "timed out waiting for the comm's wire channel",
                )
            try:
                while True:
                    # another reap may have queued our transfer while
                    # we awaited the lock: early queue first, always
                    for p in list(pending):
                        if pending.get(p, 0) > 0:
                            early = self._coll_early_pop(comm.cid, p)
                            if early is not None:
                                return p, early
                    # bounded wait, holding the channel lock, so the
                    # pump cannot add early transfers behind our back
                    # mid-wait
                    src_nid, raw = self._sliced_recv(
                        None, tag, deadline, comm,
                        lambda: [q for q, c in pending.items()
                                 if c > 0],
                        "collective reap awaiting",
                        f"collective any-source receive on "
                        f"{comm.name} timed out")
                    src = src_nid - 1
                    arr = self._finish_checked(
                        src, tag, raw, deadline,
                        epoch0=getattr(comm, "_ft_epoch0", 0))
                    if pending.get(src, 0) > 0:
                        return src, arr
                    with self._coll_early_lock:
                        self._coll_early.setdefault((comm.cid, src),
                                                    []).append(arr)
            finally:
                lk.release()
        finally:
            if tok is not None:
                _watchdog.disarm(tok)

    def _finish_transfer(self, src_pidx: int, tag: int, first_raw,
                         deadline: float):
        """Complete one payload transfer whose first frame was already
        popped by an any-source peek."""
        btl = self._btl_for(src_pidx)
        left_ms = max(1, int((deadline - time.monotonic()) * 1000))
        first = (self._nid(src_pidx), first_raw)
        if btl is self._shm:
            return btl.recv_shm(self.ep, tag, src=self._nid(src_pidx),
                                timeout_ms=left_ms, first=first)
        return btl.recv_staged(self.ep, tag, src=self._nid(src_pidx),
                               timeout_ms=left_ms, first=first)

    def _sliced_recv(self, want_src, tag: int, deadline: float,
                     comm, peers_fn, what: str, timeout_msg: str):
        """THE bounded-slice wait shared by every blocking wire
        consumer (collective reaps, peer-specific receives, ctl
        tokens): each ~100 ms slice re-checks the ULFM failure
        picture — revoked cid, peers dead for this comm's birth
        epoch — so a dead peer or a revoke interrupts the wait with
        the typed error within one detection interval; deadline
        expiry raises ERR_PENDING with ``timeout_msg``. Returns the
        ``(src_nid, raw)`` of the first matching frame."""
        from ..btl.components import stashed_recv

        epoch0 = getattr(comm, "_ft_epoch0", 0)
        while True:
            _ft().check_wait(comm.cid, peers_fn(), what, epoch0=epoch0)
            left = deadline - time.monotonic()
            if left <= 0:
                raise MPIError(ErrorCode.ERR_PENDING, timeout_msg)
            try:
                return stashed_recv(
                    self.ep, want_src, tag,
                    time.monotonic() + min(left, _FT_SLICE_S))
            except MPIError as e:
                if e.code != ErrorCode.ERR_PENDING:
                    raise  # endpoint torn down: surface it
                # slice expired: re-check the picture and re-park

    def _finish_checked(self, src_pidx: int, tag: int, first_raw,
                        deadline: float, epoch0: int = 0):
        """`_finish_transfer` with the ULFM mapping: a transfer whose
        tail never completes because the SENDER is (or becomes) dead
        FOR THIS COMM (its failure episode started at/after the comm's
        birth epoch) surfaces as ERR_PROC_FAILED — the typed error
        recovery policies key on — instead of a generic truncation. A
        rejoined replacement's flaky transfer on a post-recovery comm
        stays a flake."""
        try:
            return self._finish_transfer(src_pidx, tag, first_raw,
                                         deadline)
        except MPIError as e:
            if _ft().dead_for((src_pidx,), epoch0):
                raise MPIError(
                    ErrorCode.ERR_PROC_FAILED,
                    f"collective transfer from process {src_pidx} "
                    f"broke off mid-stream and the job epoch "
                    f"({_ft().epoch}) marks that process failed ({e})",
                )
            raise

    def sentinel_exchange(self, comm, payload: bytes,
                          timeout_ms: Optional[int] = None,
                          op: str = "sentinel_exchange"
                          ) -> Dict[int, bytes]:
        """Collective contract sentinel piggyback path (obs_sentinel=2):
        exchange one small signature frame with every member process
        on the comm's ctl channel, strictly BEFORE the round's first
        payload frame. Safe to interleave with barrier tokens: every
        process performs this exchange in the same posting-order slot
        (the progress engine serializes collectives per comm), so the
        per-(src, tag) FIFO keeps signature frames ahead of the
        round's own ctl traffic — and a frame that still arrives out
        of protocol is a loud ERR_INTERN, never silently consumed as
        a token. Sends go out to every peer before any receive parks,
        so a desynced-but-present peer always answers (both sides
        detect the mismatch; neither hangs). A stall here is the
        round's: the watchdog arm carries ``op`` (the collective's
        family) and the processes and ranks not yet heard from."""
        from ..obs import sentinel as _sentinel

        topo = proc_topology(comm)
        for p in topo.peers:
            self.ctl_send(comm, p, _sentinel.SIG_MAGIC + payload)
        out: Dict[int, bytes] = {}
        tok = None
        if _watchdog.enabled:
            def awaiting() -> Dict[str, List[int]]:
                info = _ft_split_awaiting(
                    p for p in topo.peers if p not in out)
                info["awaiting_ranks"] = sorted(
                    comm.group.world_rank(i)
                    for p in info["awaiting_procs"]
                    for i in topo.members_of.get(p, ()))
                return info

            tok = _watchdog.arm(op, comm_id=comm.cid, info=awaiting)
        try:
            for p in topo.peers:
                raw = self.ctl_recv(comm, p, timeout_ms=timeout_ms)
                if not raw.startswith(_sentinel.SIG_MAGIC):
                    raise MPIError(
                        ErrorCode.ERR_INTERN,
                        f"sentinel exchange on {comm.name} popped a "
                        f"non-signature ctl frame from process {p} — "
                        "collective/ctl ordering diverged",
                    )
                out[p] = raw[len(_sentinel.SIG_MAGIC):]
        finally:
            _watchdog.disarm(tok)
        return out

    def ctl_send(self, comm, peer_pidx: int, payload: bytes = b"") -> None:
        epoch0 = getattr(comm, "_ft_epoch0", 0)
        _ft().check_wait(comm.cid, (peer_pidx,), "ctl send",
                         epoch0=epoch0)
        self._retry(
            lambda: self.ep.send(self._nid(peer_pidx),
                                 WIRE_CTL_BASE + comm.cid,
                                 payload),
            f"ctl token to process {peer_pidx}",
            peer=peer_pidx, epoch0=epoch0,
        )

    def ctl_recv(self, comm, src_pidx: int,
                 timeout_ms: Optional[int] = None) -> bytes:
        if timeout_ms is None:  # wire_coll_timeout_ms cvar (tunable)
            timeout_ms = self.tuning().coll_timeout_ms
        tok = None
        if _watchdog.enabled:
            tok = _watchdog.arm(
                "barrier_token", comm_id=comm.cid, peer=src_pidx,
                info=lambda s=src_pidx: _ft_split_awaiting([s]))
        try:
            deadline = time.monotonic() + timeout_ms / 1000
            _, raw = self._sliced_recv(
                self._nid(src_pidx), WIRE_CTL_BASE + comm.cid,
                deadline, comm, lambda: (src_pidx,), "ctl wait on",
                f"ctl wait on process {src_pidx} timed out after "
                f"{timeout_ms} ms")
            return raw
        finally:
            if tok is not None:
                _watchdog.disarm(tok)

    def proc_barrier(self, comm, procs: List[int],
                     timeout_ms: Optional[int] = None) -> None:
        """Dissemination barrier among the participating processes
        (log2 rounds of token exchange on the comm's control channel)."""
        p = len(procs)
        if p <= 1:
            return
        me = procs.index(self.my_pidx)
        k = 1
        while k < p:
            self.ctl_send(comm, procs[(me + k) % p])
            self.ctl_recv(comm, procs[(me - k) % p],
                          timeout_ms=timeout_ms)
            k <<= 1
