"""Simulated-fleet scale harness — the real stack at P=256-4096 over
a virtual wire.

Everything in this repo was proven at 3-8 processes; the O(log P)
round claims of ``coll/hier_schedules.py``, the ULFM recovery
storms, and the sentinel forensics were all built for fleet
scale and tested at toy scale. This module closes that gap without
hardware: an in-process virtual fleet that drives the *unmodified*
production code —

- the pure round schedules of :mod:`..coll.hier_schedules`, through
  the exact ``_XchgAdapter`` exchange contract (all of a round's
  sends posted before any receive parks);
- the ULFM failure picture of :mod:`..ft.ulfm` — one real
  :class:`~..ft.ulfm.FtState` per simulated rank, fed coordinator
  notice documents through ``apply_notice``, poisoned through
  ``apply_revoke``, and consulted by every bounded virtual-wire wait
  through ``check_wait`` (the production hot-path discipline);
- the contract-sentinel chain hashing of :mod:`..obs.sentinel` — a
  per-rank rolling chain folded by the production
  :class:`~..obs.sentinel.CallSig`, journaled in the exact span shape
  ``tpu-doctor contracts`` aligns —

at hundreds to thousands of ranks, one thread per rank, no processes,
no devices, no jax.

**The virtual wire.** :class:`Fabric` models per-link latency,
bandwidth, and loss over a host topology (co-hosted ranks ride the
intra/shm link class, cross-host ranks the inter/DCN class; per-link
overrides, slow-NIC straggler multipliers, and rank-set partitions
compose on top). Time is a deterministic VIRTUAL clock: each rank
owns ``now``; a message sent at ``t`` arrives at ``t + latency +
nbytes/bandwidth`` (+ deterministic seeded retransmit penalties for
lossy links, + hold-until-heal for partition windows), and a receive
advances the receiver to ``max(now, arrival)``. Because every arrival
is a pure function of the sender's clock and the fabric parameters —
never of OS thread scheduling — per-rank clocks, the metrology, and
the event log are bit-identical across runs: seeded chaos replays are
reproducible evidence, not flaky approximations.

**Failure semantics.** Deaths are staged (``kill(p, at_round=k)``:
the rank dies at the start of its k-th exchange). A dying rank
registers an exit record carrying its precomputed coordinator notice
(epoch-stamped cumulative failed sets, the TAG_PROC_FAILED document
shape); an erroring rank revokes its communicator locally (the ULFM
errhandler pattern) and registers the revoke. A waiter whose awaited
queue stays empty consults the sender's exit record, folds the notice
/ revoke into its OWN FtState via the real ``apply_notice`` /
``apply_revoke``, and lets the real ``check_wait`` raise the typed
error — ``ERR_PROC_FAILED`` at the direct detector,
``ERR_REVOKED`` downstream — so a single staged death cascades into
exactly the revoke storm ``ft/ulfm.py`` produces, at any P.

**Metrology.** Per rank: exchange rounds, messages, bytes,
inter-host (DCN-crossing) bytes, loss retransmits, and the virtual
clock. A :meth:`FleetSim.run` returns a :class:`RunReport` of
per-run deltas, so tests assert the actual scaling curves (bcast
root sends = ceil(log2 P), recursive-doubling rounds = ceil(log2 P),
Rabenseifner inter-process send bytes/rank = 2n(P-1)/P — every
simulated rank is one process, so ``bytes_sent`` is exactly the
``hier_inter_bytes`` quantity of the real spanning collectives,
while ``inter_bytes_sent`` separately counts the host-crossing
subset) and ``bench.py``'s ``fleet_scaling`` suite emits them as
gate-guarded ``sim_*`` metric lines.

**Forensics.** Per-rank span journals (sentinel signatures, ft
events, coll rounds) dump as ``journal-p*.json`` files in the exact
shape ``obs/doctor.py`` merges — ``tpu-doctor contracts`` and the
``report`` incident timeline work on a 256-rank simulated desync the
same way they work on a 3-process real one.
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ft.ulfm import FtState
from ..obs import sentinel as _sentinel
from ..obs.journal import flow_id
from ..utils.errors import ErrorCode, MPIError

#: thread stack size for rank threads: schedules are shallow pure
#: Python + numpy, and 4096 default (8 MiB) stacks would be wasteful
THREAD_STACK = 1 << 20


class SimHang(RuntimeError):
    """A virtual-wire wait that can never complete and has no FT story
    — the simulator's watchdog: a real desync/harness bug, reported
    loudly instead of parking forever."""


class _RankKilled(BaseException):
    """Internal control flow for a staged death (BaseException so no
    schedule-level ``except Exception`` can swallow a death)."""


# ---------------------------------------------------------------------------
# fabric: links, hosts, partitions
# ---------------------------------------------------------------------------


class LinkSpec:
    """One directed link class: latency (s), bandwidth (GB/s), loss
    probability per message (modelled as deterministic retransmit
    penalties — the real wire is reliable, loss costs time)."""

    __slots__ = ("latency_s", "bytes_per_s", "loss")

    def __init__(self, latency_s: float, gb_per_s: float,
                 loss: float = 0.0) -> None:
        self.latency_s = float(latency_s)
        self.bytes_per_s = float(gb_per_s) * 1e9
        self.loss = float(loss)


#: co-hosted ranks: the shm-class link
DEFAULT_INTRA = ("intra", 1e-6, 100.0, 0.0)
#: cross-host ranks: the DCN-class link
DEFAULT_INTER = ("inter", 25e-6, 12.5, 0.0)


class Fabric:
    """The virtual wire: host topology + per-link delivery model.

    ``hosts_per`` groups ranks into hosts of that size (rank p lives
    on host ``h{p // hosts_per}``); ``host_of`` overrides with an
    explicit rank->host map. Per-link overrides (:meth:`set_link`),
    slow-NIC multipliers (:meth:`slow_nic`), and rank-set partition
    windows (:meth:`partition`) compose over the two link classes.
    Delivery times are pure functions of (src, dst, nbytes, send
    time, per-pair message index) — deterministic by construction.
    """

    def __init__(self, P: int, hosts_per: Optional[int] = None,
                 host_of: Optional[Dict[int, str]] = None,
                 intra: Optional[LinkSpec] = None,
                 inter: Optional[LinkSpec] = None,
                 seed: int = 0, rto_s: float = 1e-3) -> None:
        self.P = int(P)
        if host_of is None:
            per = int(hosts_per) if hosts_per else self.P
            host_of = {p: f"h{p // per}" for p in range(self.P)}
        self.host_of = dict(host_of)
        self.intra = intra or LinkSpec(*DEFAULT_INTRA[1:])
        self.inter = inter or LinkSpec(*DEFAULT_INTER[1:])
        self.seed = int(seed)
        self.rto_s = float(rto_s)
        self._overrides: Dict[Tuple[int, int], LinkSpec] = {}
        self._nic: Dict[int, float] = {}
        self._bw_share: Dict[int, float] = {}
        #: (ranks_a, ranks_b, t0, t1-or-None) partition windows
        self._partitions: List[Tuple[frozenset, frozenset,
                                     float, Optional[float]]] = []

    # -- topology ----------------------------------------------------------
    def host(self, p: int) -> str:
        return self.host_of.get(p, f"h{p}")

    def crosses_host(self, s: int, d: int) -> bool:
        return self.host(s) != self.host(d)

    def hosts(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for p in sorted(self.host_of):
            out.setdefault(self.host_of[p], []).append(p)
        return out

    # -- shaping -----------------------------------------------------------
    def set_link(self, s: int, d: int, spec: LinkSpec) -> None:
        self._overrides[(s, d)] = spec

    def slow_nic(self, p: int, factor: float) -> None:
        """Straggler injection: every link touching ``p`` gets
        ``factor``x the latency and 1/``factor`` the bandwidth."""
        self._nic[p] = float(factor)

    def bandwidth_share(self, p: int, share: float) -> None:
        """QoS contention model: rank ``p``'s sends see ``share`` of
        the link bandwidth (latency untouched). This is how the
        multi-tenant scenarios model a saturated shared wire under
        the weighted-fair arbiter: each class's ranks get exactly
        their fair-share fraction (``service.qos.fair_share``) of
        every link they send on — deterministic, so virtual clocks
        stay replayable."""
        self._bw_share[p] = max(1e-6, float(share))

    def partition(self, ranks_a, ranks_b, t0: float,
                  t1: Optional[float] = None) -> None:
        """Sever the (a <-> b) links for sends departing in
        [t0, t1): a finite ``t1`` holds crossing messages in the
        switch until the heal (arrival >= t1), ``t1=None`` black-holes
        them — the receiver's bounded wait then fails typed."""
        self._partitions.append((frozenset(int(p) for p in ranks_a),
                                 frozenset(int(p) for p in ranks_b),
                                 float(t0),
                                 None if t1 is None else float(t1)))

    # -- delivery ----------------------------------------------------------
    def link(self, s: int, d: int) -> Tuple[float, float, float]:
        spec = self._overrides.get((s, d))
        if spec is None:
            spec = self.intra if not self.crosses_host(s, d) else \
                self.inter
        f = self._nic.get(s, 1.0) * self._nic.get(d, 1.0)
        share = self._bw_share.get(s, 1.0)
        return (spec.latency_s * f, spec.bytes_per_s / f * share,
                spec.loss)

    def delivery(self, s: int, d: int, nbytes: int, t_send: float,
                 k: int) -> Tuple[Optional[float], int]:
        """(arrival virtual time | None if black-holed, retransmit
        count). Loss draws come from the process-independent FNV fold
        (``obs.journal.flow_id``) over (seed, s, d, k, try) — the same
        message loses the same number of times on every run."""
        lat, bps, loss = self.link(s, d)
        dt = lat + nbytes / bps
        retx = 0
        if loss > 0.0:
            loss = min(loss, 0.95)
            while retx < 64 and (
                    flow_id("fleetsim-loss", self.seed, s, d, k, retx)
                    / 2.0 ** 64) < loss:
                retx += 1
            dt += retx * self.rto_s
        arrival = t_send + dt
        for (a, b, t0, t1) in self._partitions:
            if t0 <= t_send and (t1 is None or t_send < t1) and \
                    ((s in a and d in b) or (s in b and d in a)):
                if t1 is None:
                    return None, retx
                arrival = max(arrival, t1 + lat)
        return arrival, retx


# ---------------------------------------------------------------------------
# per-rank state
# ---------------------------------------------------------------------------


class _RankState:
    __slots__ = ("p", "now", "rounds", "msgs_sent", "msgs_recvd",
                 "bytes_sent", "bytes_recvd", "inter_bytes_sent",
                 "loss_retx", "alive", "ft", "sent", "spans",
                 "msg_k", "ev_seq")

    def __init__(self, p: int) -> None:
        self.p = p
        self.now = 0.0
        self.rounds = 0
        self.msgs_sent = 0
        self.msgs_recvd = 0
        self.bytes_sent = 0
        self.bytes_recvd = 0
        self.inter_bytes_sent = 0
        self.loss_retx = 0
        self.alive = True
        self.ft = FtState()          # the REAL ULFM failure picture
        self.sent: Dict[int, Tuple[int, int]] = {}  # cid -> (seq, chain)
        self.spans: List[Dict] = []  # journal-shaped span dicts
        self.msg_k: Dict[int, int] = {}
        self.ev_seq = 0

    def snap(self) -> Tuple[float, int, int, int, int, int, int]:
        return (self.now, self.rounds, self.msgs_sent, self.msgs_recvd,
                self.bytes_sent, self.inter_bytes_sent, self.loss_retx)


class RunReport:
    """Per-run metrology deltas — what the scaling assertions and the
    ``fleet_scaling`` bench lines read."""

    def __init__(self, participants: List[int], outcomes: Dict,
                 start: Dict, end: Dict) -> None:
        self.participants = participants
        self.outcomes = outcomes
        self.rounds = {p: end[p][1] - start[p][1] for p in participants}
        self.msgs_sent = {p: end[p][2] - start[p][2]
                          for p in participants}
        self.msgs_recvd = {p: end[p][3] - start[p][3]
                           for p in participants}
        self.bytes_sent = {p: end[p][4] - start[p][4]
                           for p in participants}
        self.inter_bytes_sent = {p: end[p][5] - start[p][5]
                                 for p in participants}
        self.loss_retx = {p: end[p][6] - start[p][6]
                          for p in participants}
        self.makespan = (max(end[p][0] for p in participants)
                         - min(start[p][0] for p in participants))

    def ok(self) -> List[int]:
        return sorted(p for p, (k, _) in self.outcomes.items()
                      if k == "ok")

    def errored(self) -> List[int]:
        return sorted(p for p, (k, _) in self.outcomes.items()
                      if k == "error")

    def killed(self) -> List[int]:
        return sorted(p for p, (k, _) in self.outcomes.items()
                      if k == "killed")

    def value(self, p: int):
        kind, val = self.outcomes[p]
        if kind != "ok":
            raise AssertionError(f"rank {p} outcome {kind}: {val}")
        return val

    def max_rounds(self) -> int:
        return max(self.rounds.values())

    def min_rounds(self) -> int:
        return min(self.rounds.values())

    def max_bytes_sent(self) -> int:
        return max(self.bytes_sent.values())

    def total_msgs(self) -> int:
        return sum(self.msgs_sent.values())


# ---------------------------------------------------------------------------
# the exchange adapter (the _XchgAdapter contract over the fabric)
# ---------------------------------------------------------------------------


class FleetXchg:
    """One rank's exchange endpoint on one communicator: the adapter
    :mod:`..coll.hier_schedules` drives. Checks the rank's real
    FtState before posting and inside every bounded receive wait —
    the production wire-wait discipline."""

    __slots__ = ("fleet", "me", "cid", "epoch0")

    def __init__(self, fleet: "FleetSim", me: int, cid: int = 1,
                 epoch0: int = 0) -> None:
        self.fleet = fleet
        self.me = me
        self.cid = cid
        self.epoch0 = epoch0

    def exchange(self, sends: Dict[int, list],
                 recvs: Dict[int, int]) -> Dict[int, list]:
        fleet = self.fleet
        r = fleet.ranks[self.me]
        fleet._check_death(r)
        peers = sorted(p for p, c in recvs.items() if int(c) > 0)
        # entry check: a rank that already learned of a death/revoke
        # must not post into a poisoned round (ULFM bounded-wait rule)
        r.ft.check_wait(self.cid, peers, what="schedule round",
                        epoch0=self.epoch0)
        for dst, arrs in sends.items():
            for a in arrs:
                fleet._send(r, int(dst), np.asarray(a), self.cid)
        got: Dict[int, list] = {p: [] for p in recvs}
        for src in peers:
            for _ in range(int(recvs[src])):
                got[src].append(
                    fleet._recv(r, src, self.cid, self.epoch0))
        r.rounds += 1
        return got


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


class FleetSim:
    """P simulated ranks over a :class:`Fabric`, one thread per rank
    only while a :meth:`run` is in flight. All virtual-time outputs
    (clocks, metrology, event log, journals) are deterministic
    functions of (schedule, fabric, staged chaos) — never of thread
    timing."""

    def __init__(self, P: int, *, hosts_per: Optional[int] = None,
                 fabric: Optional[Fabric] = None, seed: int = 0,
                 detect_s: float = 2e-3, slice_s: float = 15.0,
                 real_timeout_s: float = 60.0) -> None:
        self.P = int(P)
        self.procs = list(range(self.P))
        self.fabric = fabric or Fabric(self.P, hosts_per=hosts_per,
                                       seed=seed)
        self.detect_s = float(detect_s)
        self.slice_s = float(slice_s)
        self.real_timeout_s = float(real_timeout_s)
        self.ranks = {p: _RankState(p) for p in self.procs}
        self._queues: Dict[Tuple[int, int, int], queue.Queue] = {}
        self._qlock = threading.Lock()
        self._exit: Dict[int, Dict] = {}
        self._death_doc: Dict[int, Tuple[int, Dict]] = {}
        self._die_round: Dict[int, int] = {}
        self._events: List[Tuple[float, int, int, str, Dict]] = []
        self._evlock = threading.Lock()

    # -- chaos staging -----------------------------------------------------
    def kill(self, p: int, at_round: int) -> None:
        """Stage rank ``p``'s death at the start of its ``at_round``-th
        exchange (1-based). Epochs are assigned in staging order; the
        death carries the coordinator's cumulative TAG_PROC_FAILED
        document, exactly what the real HNP pushes."""
        if p in self._death_doc:
            raise ValueError(f"rank {p} already staged to die")
        epoch = len(self._death_doc) + 1
        failed_at = {q: e for q, (e, _) in self._death_doc.items()}
        failed_at[int(p)] = epoch
        doc = {"epoch": epoch, "failed": sorted(failed_at),
               "restarted": [], "rejoined": [],
               "failed_at": {str(q): e for q, e in failed_at.items()}}
        self._death_doc[int(p)] = (epoch, doc)
        self._die_round[int(p)] = int(at_round)

    def final_notice(self) -> Optional[Dict]:
        """The coordinator's authoritative post-chaos failure document
        (the newest staged death's cumulative snapshot) — what the
        recovery agreement pushes to every survivor."""
        if not self._death_doc:
            return None
        return max(self._death_doc.values(), key=lambda t: t[0])[1]

    # -- plumbing ----------------------------------------------------------
    def xchg(self, p: int, cid: int = 1, epoch0: int = 0) -> FleetXchg:
        return FleetXchg(self, p, cid, epoch0)

    def _queue(self, s: int, d: int, cid: int) -> queue.Queue:
        key = (cid, s, d)
        q = self._queues.get(key)
        if q is None:
            with self._qlock:
                q = self._queues.setdefault(key, queue.Queue())
        return q

    def _event(self, r: _RankState, kind: str, **kv) -> None:
        r.ev_seq += 1
        with self._evlock:
            self._events.append((r.now, r.p, r.ev_seq, kind, kv))

    def event_log(self) -> List[Dict]:
        """All events so far, sorted on (virtual time, rank, per-rank
        seq) — a deterministic total order, identical across replays
        of one seeded scenario."""
        with self._evlock:
            evs = sorted(self._events)
        return [dict(t=t, pidx=p, seq=s, kind=k, **kv)
                for (t, p, s, k, kv) in evs]

    def event_log_json(self) -> str:
        return json.dumps(self.event_log(), sort_keys=True)

    def _check_death(self, r: _RankState) -> None:
        die = self._die_round.get(r.p)
        if die is not None and r.rounds >= die - 1:
            raise _RankKilled()

    def _send(self, r: _RankState, dst: int, arr: np.ndarray,
              cid: int) -> None:
        k = r.msg_k.get(dst, 0)
        r.msg_k[dst] = k + 1
        nbytes = int(arr.nbytes)
        arrival, retx = self.fabric.delivery(r.p, dst, nbytes, r.now, k)
        r.msgs_sent += 1
        r.bytes_sent += nbytes
        r.loss_retx += retx
        if self.fabric.crosses_host(r.p, dst):
            r.inter_bytes_sent += nbytes
        if arrival is None:
            # black-holed by an unhealed partition: the receiver's
            # bounded wait fails typed after the detection interval
            self._queue(r.p, dst, cid).put(("void", r.now, None))
        else:
            self._queue(r.p, dst, cid).put(("msg", arrival, arr))

    def _recv(self, r: _RankState, src: int, cid: int,
              epoch0: int) -> np.ndarray:
        q = self._queue(src, r.p, cid)
        deadline = time.monotonic() + self.real_timeout_s
        while True:
            try:
                # park slices exist only as a SimHang safety net: an
                # exiting rank wakes its waiters with explicit exit
                # markers, so a healthy fleet never times out here —
                # which is what keeps thousands of parked threads from
                # thrashing one GIL with spurious timed wakeups
                kind, vt, payload = q.get(timeout=self.slice_s)
            except queue.Empty:
                info = self._exit.get(src)
                if info is not None:
                    # belt-and-braces: the sender exited (its marker
                    # may sit on a queue we had not created yet when
                    # it was broadcast) — fold its exit story and let
                    # the real check_wait raise the typed ULFM error
                    self._fold_exit(r, src, info, cid, epoch0)
                if time.monotonic() > deadline:
                    raise SimHang(
                        f"rank {r.p}: recv from {src} on cid {cid} "
                        f"parked past {self.real_timeout_s}s real "
                        f"time (virtual now {r.now:.6f})")
                continue
            if kind == "msg":
                r.msgs_recvd += 1
                r.bytes_recvd += int(payload.nbytes)
                r.now = max(r.now, vt)
                return payload
            if kind == "exit":
                # every message the sender ever posted on this pair
                # precedes its marker (program order), so detection
                # is deterministic: drain, then learn why it exited
                self._fold_exit(r, src, payload, cid, epoch0)
                continue  # pragma: no cover - _fold_exit raises
            # "void": sent into a severed link, can never arrive
            r.now = max(r.now, vt + self.detect_s)
            self._event(r, "unreachable", peer=src)
            raise MPIError(
                ErrorCode.ERR_UNREACH,
                f"recv from process {src}: virtual wire partitioned "
                f"with no heal (send at t={vt:.6f})")

    def _apply_notice(self, r: _RankState, doc: Dict,
                      vt: float) -> None:
        """Fold one coordinator failure document into rank ``r``'s
        real FtState, journaling each NEWLY learned failure the way
        the production emitter does (layer ft, peer=failed pidx,
        comm=epoch)."""
        pre = set(r.ft.failed_at)
        r.ft.apply_notice(doc)          # the real parser/monotonicity
        for q in sorted(set(r.ft.failed_at) - pre):
            r.spans.append({"seq": len(r.spans), "op": "ft_failure",
                            "layer": "ft", "t": vt, "dt": 0.0,
                            "bytes": 0, "peer": int(q),
                            "comm": int(r.ft.epoch)})
            self._event(r, "learned_failure", failed=int(q),
                        epoch=int(r.ft.epoch))

    def _apply_revoke(self, r: _RankState, cid: int,
                      epoch: int, vt: float) -> None:
        if r.ft.apply_revoke(cid, epoch):   # the real poison fold
            r.spans.append({"seq": len(r.spans), "op": "ft_revoke",
                            "layer": "ft", "t": vt, "dt": 0.0,
                            "bytes": 0, "peer": int(epoch),
                            "comm": int(cid)})
            self._event(r, "revoke", cid=int(cid), epoch=int(epoch))

    def _fold_exit(self, r: _RankState, src: int, info: Dict,
                   cid: int, epoch0: int) -> None:
        """The awaited sender exited: learn why through the real ULFM
        state machine and raise its typed error. Raises SimHang when
        the exit has no FT story this comm can see (a genuine desync:
        the sender finished a different call stream)."""
        vt = max(r.now, float(info["vt"]) + self.detect_s)
        r.now = vt
        notice = info.get("notice")
        if notice:
            self._apply_notice(r, notice, vt)
        for c in info.get("revoked", ()):
            self._apply_revoke(r, int(c), int(info.get("epoch", -1)),
                               vt)
        r.ft.check_wait(cid, (src,),
                        what=f"recv from process {src}",
                        epoch0=epoch0)
        raise SimHang(
            f"rank {r.p}: peer {src} exited ({info['kind']}) without "
            f"sending the awaited message on cid {cid} and with no "
            f"visible FT story — call streams desynced")

    def _register_exit(self, p: int, info: Dict, cid: int) -> None:
        # program order guarantees every message this rank ever posted
        # precedes the exit record: waiters drain the pair queue
        # before seeing the marker, so detection is deterministic
        info["cid"] = cid
        self._exit[p] = info
        # wake every potential waiter on this comm with an explicit
        # marker (parked receives block indefinitely by design)
        for q in self.procs:
            if q != p:
                self._queue(p, q, cid).put(("exit", info["vt"], info))

    # -- sentinel ----------------------------------------------------------
    def note_collective(self, p: int, cid: int, family: str,
                        op_name: str = "-", dtype: str = "-",
                        count: int = 0, root: int = -1,
                        site: Optional[str] = None):
        """Fold one collective call signature into rank ``p``'s
        per-comm rolling chain using the production
        :class:`~..obs.sentinel.CallSig` hashing, and journal it in
        the exact sentinel span shape ``tpu-doctor contracts``
        aligns. ``site`` must stay pipe-free (the encode_op wire
        format)."""
        r = self.ranks[p]
        canon = _sentinel.make_canon(family, op_name, dtype,
                                     int(count), int(root))
        epoch = int(r.ft.epoch)
        site = site or f"fleet_sim:{family}"
        seq, chain = r.sent.get(cid, (0, 0))
        cs = _sentinel.CallSig(cid, seq, family, canon, epoch, site,
                               chain)
        r.sent[cid] = (seq + 1, cs.chain)
        r.spans.append({"seq": len(r.spans),
                        "op": _sentinel.encode_op(canon, epoch, site),
                        "layer": "sentinel", "t": r.now, "dt": 0.0,
                        "bytes": max(int(count), 0), "peer": seq,
                        "comm": int(cid), "flow": cs.chain,
                        "fs": "g"})
        return cs

    def chain_of(self, p: int, cid: int) -> int:
        return self.ranks[p].sent.get(cid, (0, 0))[1]

    def record_recovery(self, p: int, new_cid: int, step: int,
                        duration_s: float) -> None:
        """Journal a recovery completion the way ``ft/errmgr`` does
        (layer ft, comm=new cid, peer=step, dt=duration)."""
        r = self.ranks[p]
        r.spans.append({"seq": len(r.spans), "op": "ft_recovery",
                        "layer": "ft", "t": r.now,
                        "dt": float(duration_s), "bytes": 0,
                        "peer": int(step), "comm": int(new_cid)})
        self._event(r, "recovered", new_cid=int(new_cid),
                    step=int(step))

    # -- journals ----------------------------------------------------------
    def write_journals(self, directory: str,
                       ranks: Optional[Sequence[int]] = None) -> int:
        """One ``journal-p*.json`` per rank in the rank_dump shape
        ``obs/doctor.py::load_dir`` reads — the forensics tools work
        on simulated fleets unmodified. Returns the file count."""
        os.makedirs(directory, exist_ok=True)
        n = 0
        for p in (self.procs if ranks is None else ranks):
            r = self.ranks[p]
            doc = {"meta": {"pidx": p, "rank_offset": p,
                            "local_size": 1, "clock_offset_s": 0.0,
                            "fleet_sim": True},
                   "spans": r.spans}
            with open(os.path.join(directory,
                                   f"journal-p{p:05d}.json"),
                      "w") as f:
                json.dump(doc, f)
            n += 1
        return n

    # -- running -----------------------------------------------------------
    def run(self, fn: Callable, *, ranks: Optional[Sequence[int]] = None,
            cid=1, epoch0: int = 0, label: Optional[str] = None,
            sig=None, timeout_s: Optional[float] = None) -> RunReport:
        """Run ``fn(xchg, p)`` on every participating rank (one thread
        each) and return the per-run :class:`RunReport`.

        ``sig`` notes a collective signature per rank before the run:
        a (family, op, dtype, count, root) tuple, or a callable
        ``sig(p) -> tuple | None`` for per-rank divergence injection.
        ``label`` journals one coll-layer span per completing rank
        (skew-report food). Queues are scoped by ``cid``: recovery
        reruns on a fresh cid never see a chaotic run's orphans.

        ``cid`` may be a callable ``cid(p) -> int`` — the multi-tenant
        shape: disjoint tenant rank sets run their own schedules on
        their own (band-scoped) cids inside ONE run, and a death's
        exit markers ripple only through the dead rank's cid queues —
        one tenant's failure storm never touches another's wire.
        """
        cid_of = cid if callable(cid) else (lambda _p, _c=cid: _c)
        parts = list(self.procs if ranks is None else ranks)
        for p in parts:
            if not self.ranks[p].alive:
                raise ValueError(f"rank {p} is dead; exclude it")
            info = self._exit.pop(p, None)  # (re)joining this run
            if info is not None and info.get("cid") == cid_of(p):
                # its exit markers (and possibly undrained payloads)
                # still sit on this cid's queues; replaying over them
                # would fail spuriously. Production ULFM has the same
                # rule: a comm that saw a failure is revoked and
                # REBUILT — rejoin on a fresh cid (ft_cid).
                raise ValueError(
                    f"rank {p} exited the previous run on cid "
                    f"{cid_of(p)} ({info['kind']}); rerun survivors "
                    "on a fresh cid (the ULFM revoke -> rebuild shape)")
        start = {p: self.ranks[p].snap() for p in parts}
        out: Dict[int, Tuple[str, object]] = {}

        def worker(p):
            r = self.ranks[p]
            pcid = cid_of(p)
            x = FleetXchg(self, p, pcid, epoch0)
            try:
                if sig is not None:
                    s = sig(p) if callable(sig) else sig
                    if s is not None:
                        self.note_collective(p, pcid, *s)
                t0 = r.now
                val = fn(x, p)
                if label:
                    r.spans.append({"seq": len(r.spans), "op": label,
                                    "layer": "coll", "t": t0,
                                    "dt": r.now - t0, "bytes": 0,
                                    "peer": -1, "comm": int(pcid)})
                self._event(r, "done", op=label or "run")
                out[p] = ("ok", val)
            except _RankKilled:
                epoch, doc = self._death_doc[p]
                r.alive = False
                self._event(r, "died", epoch=epoch)
                self._register_exit(p, {"kind": "dead", "vt": r.now,
                                        "notice": doc, "revoked": (),
                                        "epoch": epoch}, pcid)
                out[p] = ("killed", r.now)
            except MPIError as e:
                # the ULFM errhandler pattern: the detector revokes
                # the comm, and the revoke cascades via exit records
                self._apply_revoke(r, pcid, int(r.ft.epoch), r.now)
                self._event(r, "error", code=e.code.name)
                self._register_exit(
                    p, {"kind": "error", "vt": r.now,
                        "notice": {
                            "epoch": int(r.ft.epoch),
                            "failed": sorted(r.ft.failed),
                            "restarted": [], "rejoined": [],
                            "failed_at": {str(q): e2 for q, e2
                                          in r.ft.failed_at.items()},
                        },
                        "revoked": (pcid,), "epoch": int(r.ft.epoch)},
                    pcid)
                out[p] = ("error", e)
            except SimHang as e:
                self._event(r, "hang", detail=str(e)[:120])
                self._register_exit(p, {"kind": "hang", "vt": r.now,
                                        "notice": None, "revoked": (),
                                        "epoch": int(r.ft.epoch)},
                                    pcid)
                out[p] = ("hang", e)
            except Exception as e:  # pragma: no cover - harness bug
                self._event(r, "crash", detail=str(e)[:120])
                self._register_exit(p, {"kind": "crash", "vt": r.now,
                                        "notice": None, "revoked": (),
                                        "epoch": int(r.ft.epoch)},
                                    pcid)
                out[p] = ("crash", e)

        old_stack = threading.stack_size()
        try:
            threading.stack_size(THREAD_STACK)
        except (ValueError, RuntimeError):  # pragma: no cover
            pass
        try:
            # the stack-size global is consumed at start() time, not
            # Thread() construction — it must stay set through here
            threads = [threading.Thread(target=worker, args=(p,),
                                        daemon=True) for p in parts]
            for t in threads:
                t.start()
        finally:
            try:
                threading.stack_size(old_stack)
            except (ValueError, RuntimeError):  # pragma: no cover
                pass
        deadline = time.monotonic() + (timeout_s if timeout_s
                                       is not None
                                       else self.real_timeout_s + 30)
        for t in threads:
            t.join(max(0.1, deadline - time.monotonic()))
        missing = [p for p in parts if p not in out]
        if missing:
            raise SimHang(f"{len(missing)} rank thread(s) never "
                          f"finished: {missing[:8]}...")
        end = {p: self.ranks[p].snap() for p in parts}
        return RunReport(parts, out, start, end)


# ---------------------------------------------------------------------------
# scaling-law helpers (shared by tests and the bench suite)
# ---------------------------------------------------------------------------


def log2_rounds(P: int) -> int:
    """ceil(log2 P) — THE round/fan-out count every O(log P) claim
    asserts against."""
    return int(math.ceil(math.log2(P))) if P > 1 else 0


def rabenseifner_bytes_per_rank(n_elems: int, itemsize: int,
                                P: int) -> int:
    """Exact per-rank send bytes of the Rabenseifner allreduce at a
    power-of-two P (chunks pad to per=ceil(n/P) elements): (P-1)
    chunks out in the halving reduce-scatter plus (P-1) chunks back
    in the doubling allgather — 2n(P-1)/P bytes, the O(n) bound the
    (P-1)n linear path is measured against."""
    per = -(-int(n_elems) // P)
    return 2 * (P - 1) * per * int(itemsize)
