"""Communicators — the ``ompi/communicator`` analogue over rank-stacked
torch tensors (counterpart of ``ompi_release_tpu/comm/communicator.py``).

A communicator binds a :class:`Group` to the devices of its ranks,
carries a CID, attributes, an error handler, and a per-communicator
table of collective implementations installed by priority query over
the coll framework (``coll_base_comm_select.c:66-88``).

Driver-mode data convention (single controller): collectives take one
buffer with a leading ``size`` axis, row i being rank i's buffer — a
torch tensor, or a numpy array that is moved to the communicator's
device — and return the same layout. All of a communicator's rows live
on one device: the device of its first rank (virtual ranks share it).

Ported so far: WORLD/SELF, dup/create/split/split_type_shared/free,
attributes, info objects, the ``submesh`` of each comm's devices,
errhandlers, the blocking collectives (rooted, scan and v-variants
included), which dispatch through ``coll/plan.py`` (a seen call
signature fires its frozen plan, on the card a CUDA graph), the
nonblocking i-family, ``ibarrier`` and the persistent ``*_init``
collectives (``coll/nbc.py``), the small-message fusion buffer, and
point-to-point through the per-comm PML engine (driver mode: the acting
rank is the keyword ``rank=``), and the spanning branches of the
unified multi-process world: a communicator whose members live in
several ``tpurun`` workers knows its ``local_comm_ranks``, reports
``spans_processes``, and selects the ``hier`` collectives and the wire
PML. ULFM: ``revoke`` poisons a comm (its frozen plans are dropped with
it), ``agree`` and ``shrink`` go through the coordinator, and every
communication entry point of a revoked comm raises ``ERR_REVOKED``; a
spanning collective whose member process the job epoch marks failed
raises ``ERR_PROC_FAILED`` before it is posted.

CID allocation: the reference's agreement (``comm_cid.c``) reduces to
a deterministic monotone counter, identical on every process because
every process creates every communicator in the same order (driver
mode: a split builds each color's comm everywhere, with or without
local members). Runtime-private comms (the ``hier`` module's
process-local shadow) exist only where they have members, so they draw
NEGATIVE cids from a counter of their own and never desynchronize the
shared one. A family of comms that only some processes create (a
``comm/dpm.py`` accept/connect pair and every comm derived from it)
draws from a :class:`CidBlock` its port's owner reserved, so the shared
counter stays identical everywhere. A rebuilt communicator (ULFM shrink
or respawn) takes the cid ``ft_cid`` derives from the agreed epoch and
its lineage. The bands of the cid space and ``ft_cid`` are laid out in
``utils/cids.py``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ft import ulfm as _ulfm
from ..mca import pvar
from ..obs import sentinel as _sentinel
from ..runtime.mesh import build_submesh
from ..utils import output
from ..utils.cids import CID_BAND, CID_LIMIT, DPM_CID_BASE
from ..utils.errors import Errhandler, ErrorCode, MPIError, ERRORS_ARE_FATAL
from .group import Group, UNDEFINED

_log = output.stream("comm")
_cid_counter = itertools.count(0)
#: internal (runtime-private) communicators draw negative cids
_internal_cid_counter = itertools.count(-1, -1)
_cid_lock = threading.Lock()
_fusion_create_lock = threading.Lock()
_comm_registry: Dict[int, "Communicator"] = {}

_comm_count = pvar.counter("comm_active_count", "live communicators")


def _next_cid(internal: bool = False) -> int:
    with _cid_lock:
        cid = next(_internal_cid_counter if internal else _cid_counter)
    if cid >= CID_BAND:
        raise MPIError(ErrorCode.ERR_INTERN,
                       f"the job's cid space is exhausted ({CID_BAND})")
    return cid


class CidBlock:
    """A run of cids ``[base, base + size)`` for one family of
    communicators that only some processes create: a dpm pair, its
    bridge, and every comm derived from them (merge, dup, split). The
    processes taking part create the family in the same order, so they
    draw the same cids, and the shared counter of the other processes
    never falls behind."""

    def __init__(self, base: int, size: int) -> None:
        if base < DPM_CID_BASE or base + size > CID_LIMIT:
            raise MPIError(ErrorCode.ERR_INTERN,
                           f"cid block [{base}, {base + size}) lies "
                           f"outside [{DPM_CID_BASE}, {CID_LIMIT})")
        self.base, self.size = base, size
        self._next = base

    def take(self) -> int:
        with _cid_lock:
            cid = self._next
            if cid >= self.base + self.size:
                raise MPIError(
                    ErrorCode.ERR_INTERN,
                    f"cid block [{self.base}, {self.base + self.size}) "
                    "is exhausted: too many comms derived from one "
                    "connect/accept pair")
            self._next += 1
        return cid


def cids_in_use(base: int, size: int) -> bool:
    """Whether a live communicator of this process holds a cid in
    ``[base, base + size)``."""
    return any(base <= c < base + size for c in list(_comm_registry))


def _evict_for(cid: int) -> None:
    """Make room for a comm built at the explicit ``cid``. A REVOKED or
    freed occupant (the epoch-wrapped slot of this lineage's own
    poisoned ancestor) is evicted — ULFM never lets it be used again —
    with a real free, so its teardown hooks run and its frozen plans go;
    a LIVE occupant is a real collision and a loud error. Any stale
    revocation record for the slot belongs to an ancestor and is
    forgotten, or every wire wait on the fresh comm would raise
    ERR_REVOKED at once."""
    occupant = _comm_registry.get(cid)
    if occupant is not None and (occupant._revoked or occupant._freed):
        if not occupant._freed:
            try:
                occupant.free()
            except MPIError:
                # a poisoned drain must not block the rebuild; its plans
                # go all the same
                occupant._drop_plans()
        _comm_registry.pop(cid, None)
        occupant = None
    if occupant is not None:
        raise MPIError(
            ErrorCode.ERR_COMM,
            f"explicit cid {cid} already registered ({occupant.name}) "
            "— free it before rebuilding at the same epoch")
    _ulfm.state().clear_revoked(cid)
    # the evicted ancestor's sentinel chain goes with it: a leftover
    # posting seq would false-mismatch the rebuilt comm against a
    # restarted-from-zero replacement
    _sentinel.clear_chain(cid)


def clear_comm_registry() -> None:
    """Finalize-time teardown: mark every live communicator freed (so
    stale handles raise instead of silently working) and drop their
    frozen plans."""
    from ..coll import plan as _coll_plan

    for c in list(_comm_registry.values()):
        c._freed = True
        _comm_count.add(-1)
        _coll_plan.clear_comm(c.cid)
    _comm_registry.clear()


class Keyval:
    """MPI_Comm_create_keyval analogue."""

    _counter = itertools.count(0)

    def __init__(self, copy_fn: Optional[Callable] = None,
                 delete_fn: Optional[Callable] = None,
                 extra_state: Any = None) -> None:
        self.id = next(Keyval._counter)
        self.copy_fn = copy_fn
        self.delete_fn = delete_fn
        self.extra_state = extra_state


class Communicator:
    is_inter = False  # Intercommunicator overrides (MPI_Comm_test_inter)

    def __init__(self, runtime, group: Group, *, name: str = "",
                 parent: Optional["Communicator"] = None,
                 internal: bool = False,
                 cid_block: Optional[CidBlock] = None,
                 cid: Optional[int] = None) -> None:
        self.runtime = runtime
        self.group = group
        if cid_block is None and not internal:
            cid_block = getattr(parent, "cid_block", None)
        #: where this comm and the comms derived from it draw their cids
        #: (None: the shared counter)
        self.cid_block = None if internal else cid_block
        if cid is not None:
            # explicit cid: the ULFM shrink/rebuild path derives it from
            # the HNP-agreed epoch (ft/ulfm.ft_cid)
            _evict_for(cid)
            self.cid = cid
        elif self.cid_block is not None:
            self.cid = self.cid_block.take()
        else:
            self.cid = _next_cid(internal)
        self._revoked = False  # ULFM revocation flag (see revoke())
        # ULFM lineage anchor: shrink/rebuild children inherit the
        # ORIGINAL comm's identity, so across ANY number of recoveries
        # every participant — a survivor holding rebuild#N, a fresh
        # replacement holding only its world — keys the recovery
        # agreement and the epoch-derived cid on the same value
        if cid is not None and parent is not None:
            self._ft_lineage = getattr(parent, "_ft_lineage", parent.cid)
        else:
            self._ft_lineage = self.cid
        # the job epoch this comm was born at: ULFM failures are
        # permanent per communicator, so bounded waits compare each
        # peer's failure episode against THIS epoch — a replacement
        # incarnation is visible only to comms built after its rejoin
        self._ft_epoch0 = _ulfm.state().epoch
        self.name = name or f"comm{self.cid}"
        self.errhandler: Errhandler = (
            parent.errhandler if parent else ERRORS_ARE_FATAL
        )
        from .info import Info

        parent_info = getattr(parent, "info", None)
        self.info: Info = (parent_info.dup() if isinstance(parent_info, Info)
                           else Info())  # MPI_Comm_set/get_info object
        self.topo = None  # topology (cart/graph), set by topo/topo.py
        self._attrs: Dict[int, Any] = {}
        self._freed = False
        # Local membership: under a unified multi-process world this
        # process owns only a span of world ranks; the submesh (and
        # every in-process collective) covers the LOCAL members, while
        # cross-process traffic rides the wire (hier coll + wire pml).
        if getattr(runtime, "unified", False):
            off = runtime.local_rank_offset
            cnt = runtime.local_size
            self.local_comm_ranks = [
                i for i, wr in enumerate(group.world_ranks)
                if off <= wr < off + cnt
            ]
            self.spans_processes = len(self.local_comm_ranks) < group.size
            local_positions = [group.world_rank(i) - off
                               for i in self.local_comm_ranks]
        else:
            self.local_comm_ranks = list(range(group.size))
            self.spans_processes = False
            local_positions = list(group.world_ranks)
        #: the 1-D "rank" mesh of the LOCAL members' devices, in group
        #: order (None for a comm with no members in this process: its
        #: operations can only be invoked where its ranks live)
        self.submesh = (build_submesh(runtime.mesh, local_positions)
                        if local_positions else None)
        #: the device holding the comm's rank-stacked buffers: its
        #: first local rank's
        self.device: Optional[torch.device] = (
            self.submesh.devices[0] if self.submesh is not None else None)

        # per-comm collective table (c_coll analogue), installed at
        # creation time exactly like coll_base_comm_select
        from ..coll import base as coll_base

        self.c_coll = (coll_base.comm_select(self)
                       if self.submesh is not None else {})
        _comm_registry[self.cid] = self
        _comm_count.add()
        _log.verbose(2, f"created {self.name} cid={self.cid} size={self.size}")

    # -- queries -----------------------------------------------------------
    @property
    def size(self) -> int:
        return self.group.size

    def rank_of(self, world_rank: int) -> int:
        return self.group.rank_of(world_rank)

    @property
    def is_self(self) -> bool:
        return self.size == 1

    def _check_alive(self) -> None:
        if self._freed:
            raise MPIError(ErrorCode.ERR_COMM, f"{self.name} already freed")

    def _check_usable(self) -> None:
        """Alive AND not revoked: every communication entry point runs
        this (ULFM: all ops except agree/shrink/get_failed fail with
        ERR_REVOKED on a revoked communicator). The flag is set by
        revoke() locally and by the FT watcher when a peer's poison
        frame arrives."""
        self._check_alive()
        if self._revoked:
            raise MPIError(
                ErrorCode.ERR_REVOKED,
                f"{self.name} (cid {self.cid}) has been revoked — "
                "shrink() or rebuild it to continue",
            )

    # -- construction ------------------------------------------------------
    def dup(self, name: str = "") -> "Communicator":
        self._check_alive()
        c = Communicator(self.runtime, self.group,
                         name=name or f"dup({self.name})", parent=self)
        c.topo = self.topo
        # MPI_Comm_dup runs attribute copy callbacks
        for kv_id, value in list(self._attrs.items()):
            kv = _keyval_table.get(kv_id)
            if kv and kv.copy_fn:
                keep, new_val = kv.copy_fn(self, kv, value, kv.extra_state)
                if keep:
                    c._attrs[kv_id] = new_val
            elif kv:
                c._attrs[kv_id] = value
        return c

    def create(self, group: Group, name: str = "") -> Optional["Communicator"]:
        """MPI_Comm_create: new comm over a subgroup (None if empty)."""
        self._check_alive()
        if group.size == 0:
            return None
        for r in group.world_ranks:
            if self.group.rank_of(r) == UNDEFINED:
                raise MPIError(ErrorCode.ERR_GROUP,
                               f"rank {r} not in parent {self.name}")
        return Communicator(self.runtime, group, name=name, parent=self)

    def split(self, colors: Sequence[int], keys: Optional[Sequence[int]] = None
              ) -> List[Optional["Communicator"]]:
        """MPI_Comm_split, driver mode: per-rank colors/keys vectors.

        Returns one entry per rank: the communicator that rank landed in
        (ranks sharing a color share the object), or None for
        color=UNDEFINED.
        """
        self._check_alive()
        if len(colors) != self.size:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"need {self.size} colors, got {len(colors)}")
        keys = list(keys) if keys is not None else [0] * self.size
        buckets: Dict[int, List[Tuple[int, int]]] = {}
        for local, (color, key) in enumerate(zip(colors, keys)):
            if color == UNDEFINED:
                continue
            if color < 0:
                raise MPIError(ErrorCode.ERR_ARG, f"negative color {color}")
            buckets.setdefault(color, []).append((key, local))
        result: List[Optional[Communicator]] = [None] * self.size
        for color in sorted(buckets):
            members = sorted(buckets[color])  # by (key, local-rank), MPI rule
            g = Group([self.group.world_rank(l) for _, l in members])
            sub = Communicator(self.runtime, g,
                               name=f"split({self.name},{color})",
                               parent=self)
            for _, local in members:
                result[local] = sub
        return result

    def split_type_shared(self) -> List["Communicator"]:
        """MPI_Comm_split_type(COMM_TYPE_SHARED): group by host process
        (one controller process: one communicator; under a unified
        world each process's ranks form one process-local comm)."""
        eps = {e.rank: e for e in self.runtime.endpoints}
        colors = [eps[self.group.world_rank(i)].process_index
                  for i in range(self.size)]
        return self.split(colors)  # type: ignore[return-value]

    def free(self) -> None:
        self._check_alive()
        from ..coll import nbc as _nbc
        from ..coll import plan as _coll_plan

        # schedules submitted on the comm run before it dies (a late
        # completion, not a lost request)
        _nbc.drain_comm(self)
        for kv_id, value in list(self._attrs.items()):
            kv = _keyval_table.get(kv_id)
            if kv and kv.delete_fn:
                kv.delete_fn(self, kv, value, kv.extra_state)
        self._attrs.clear()
        # runtime-private dependents (the hier module's shadow comm)
        # registered teardown hooks: free them with their owner
        for cb in getattr(self, "_on_free", ()):
            try:
                cb()
            except MPIError:
                pass  # already freed
        _comm_registry.pop(self.cid, None)
        _sentinel.clear_chain(self.cid)
        # frozen plans (and their graphs' memory pool) die with the comm:
        # a reused cid must never fire a dead comm's plans
        _coll_plan.clear_comm(self.cid)
        self._freed = True
        _comm_count.add(-1)

    def _drop_plans(self) -> None:
        """Drop the frozen plans of this comm and of its hier shadow:
        their CUDA graphs and pool, wire plans and C executors (a
        revoked comm never fires again, and a rebuild that reuses the
        cid must record afresh). Its sentinel chain goes too: the
        contract story of a revoked comm is closed."""
        from ..coll import plan as _coll_plan

        _sentinel.clear_chain(self.cid)
        _coll_plan.clear_comm(self.cid)
        m = getattr(self, "_hier_module", None)
        shadow = getattr(m, "shadow", None)
        if shadow is not None:
            _coll_plan.clear_comm(shadow.cid)

    # -- attributes (MPI keyvals) ------------------------------------------
    def set_attr(self, keyval: Keyval, value: Any) -> None:
        self._check_alive()
        self._attrs[keyval.id] = value

    def get_attr(self, keyval: Keyval) -> Tuple[bool, Any]:
        v = self._attrs.get(keyval.id, _MISSING)
        if v is _MISSING:
            return False, None
        return True, v

    def delete_attr(self, keyval: Keyval) -> None:
        v = self._attrs.pop(keyval.id, _MISSING)
        if v is not _MISSING and keyval.delete_fn:
            keyval.delete_fn(self, keyval, v, keyval.extra_state)

    # -- errors ------------------------------------------------------------
    def set_errhandler(self, handler: Errhandler) -> None:
        self.errhandler = handler

    def call_errhandler(self, err: MPIError) -> None:
        self.errhandler.invoke(self, err)

    def abort(self, errorcode: int = 1):
        """MPI_Abort analogue."""
        raise SystemExit(f"MPI_Abort on {self.name} with errorcode {errorcode}")

    # -- ULFM fault tolerance (MPIX_Comm_revoke/shrink/agree) --------------
    def _member_procs(self) -> List[int]:
        """Process indices owning this comm's ranks (spanning comms;
        [my process] otherwise)."""
        if not self.spans_processes:
            return [int(self.runtime.bootstrap.get("process_index", 0))]
        from ..runtime.wire import proc_topology

        return proc_topology(self).procs

    @property
    def revoked(self) -> bool:
        return self._revoked

    def revoke(self) -> None:
        """``MPIX_Comm_revoke``: epoch-stamped poison. Marks the comm
        revoked locally (every pending bounded wait on its wire
        channels raises ERR_REVOKED within one slice, queued
        progress-engine schedules complete in error without running,
        its frozen plans are dropped), then pushes TAG_FT_REVOKE frames
        to every live peer process so THEIR pending ops are
        interrupted too. Idempotent; never raises on a dead peer — a
        corpse needs no poison."""
        self._check_alive()
        st = _ulfm.state()
        self._revoked = True
        first = st.apply_revoke(self.cid, st.epoch)
        agent = getattr(self.runtime, "agent", None)
        if not first or agent is None or not self.spans_processes:
            return
        from ..runtime.wire import proc_topology

        for p in proc_topology(self).peers:
            if p in st.failed:
                continue
            try:
                agent.ft_revoke_notify(p, self.cid, st.epoch)
            except MPIError:
                pass  # peer died between the check and the send
        _log.verbose(1, f"{self.name} revoked (epoch {st.epoch})")

    def get_failed(self) -> List[int]:
        """``MPIX_Comm_get_failed``: this comm's ranks owned by
        processes the job epoch marks failed."""
        self._check_alive()
        if not self.spans_processes:
            return []
        from ..runtime.wire import proc_topology

        topo = proc_topology(self)
        dead = set(_ulfm.state().dead_for(set(topo.owner),
                                          self._ft_epoch0))
        return [i for i in range(self.size) if topo.owner[i] in dead]

    def agree(self, flag: bool = True, *, aseq: Optional[int] = None,
              timeout_ms: int = 60_000) -> bool:
        """``MPIX_Comm_agree``: fault-tolerant AND of ``flag`` across
        the comm's LIVE member processes, arbitrated by the HNP
        coordinator (failed contributors are excused as the epoch
        marks them). Works on a revoked communicator — it is the one
        collective ULFM guarantees through failures."""
        self._check_alive()
        agent = getattr(self.runtime, "agent", None)
        if agent is None or not self.spans_processes:
            return bool(flag)
        if aseq is None:
            aseq = self._agree_counter = getattr(
                self, "_agree_counter", 0) + 1
        doc = agent.ft_agree(self.cid, aseq, 1 if flag else 0,
                             self._member_procs(), timeout_ms=timeout_ms)
        return bool(doc.get("flag", 0))

    def shrink(self, name: str = "", *,
               timeout_ms: int = 60_000) -> "Communicator":
        """``MPIX_Comm_shrink``: agree on the surviving group through
        the coordinator (every survivor receives ONE consistent
        epoch/failed snapshot), build a new communicator over it with a
        fresh epoch-derived cid — fresh wire channels, rebuilt hier
        topology via the normal per-comm coll selection — and barrier
        the survivors on it to prove the wiring. Valid on a revoked (or
        failure-poisoned) communicator; the parent is left revoked."""
        self._check_alive()
        agent = getattr(self.runtime, "agent", None)
        if agent is None or not self.spans_processes:
            # no failure domain beyond this process: ULFM shrink of a
            # fault-free comm is a plain dup
            return self.dup(name or f"shrink({self.name})")
        from ..runtime.wire import proc_topology

        topo = proc_topology(self)
        aseq = self._agree_counter = getattr(
            self, "_agree_counter", 0) + 1
        doc = agent.ft_agree(self._ft_lineage, aseq, 1, topo.procs,
                             timeout_ms=timeout_ms)
        epoch = int(doc.get("epoch", 0))
        # dead FOR THIS COMM, from the agreement's ONE shared snapshot:
        # the transient failed set PLUS every process whose failure
        # episode began at/after this comm's birth epoch — under the
        # restart policy a corpse moves failed->restarted within
        # milliseconds of promotion, and a shrink that re-included it
        # would park the survivor barrier on a process that never
        # builds this cid
        failed = set(int(p) for p in doc.get("failed", ()))
        failed |= {p for p, e in _ulfm.failed_at_of(doc).items()
                   if e >= self._ft_epoch0}
        survivors = Group([
            self.group.world_rank(i) for i in range(self.size)
            if topo.owner[i] not in failed
        ])
        if survivors.size == 0:
            raise MPIError(ErrorCode.ERR_GROUP,
                           f"shrink({self.name}): no survivors")
        new = Communicator(
            self.runtime, survivors,
            name=name or f"shrink({self.name})", parent=self,
            cid=_ulfm.ft_cid(epoch, self._ft_lineage),
        )
        if new.spans_processes:
            self.runtime.wire.proc_barrier(
                new, proc_topology(new).procs, timeout_ms=timeout_ms)
        _log.verbose(
            1, f"shrink({self.name}) -> {new.name} cid={new.cid} "
               f"size={new.size} (epoch {epoch}, "
               f"failed procs {sorted(failed)})")
        return new

    def _ft_fastfail(self, op_name: str) -> None:
        """ULFM fast fail before a spanning collective is posted: it
        involves every member, so a known-failed member process fails
        the op NOW with the typed error instead of posting a schedule
        doomed to park."""
        _ulfm.state().check_wait(
            self.cid, self._member_procs(),
            f"collective {op_name} on {self.name} with member process",
            epoch0=self._ft_epoch0)

    # -- collectives (dispatch through the installed c_coll table) ---------
    def _coll(self, op_name: str) -> Callable:
        self._check_usable()
        fn = self.c_coll.get(op_name)
        if fn is None:
            raise MPIError(ErrorCode.ERR_INTERN,
                           f"no {op_name} implementation installed on "
                           f"{self.name}")
        if self.spans_processes:
            # spanning comms: EVERY collective — blocking or not — goes
            # through the progress engine as "post schedule + wait", so
            # blocking and nonblocking calls execute in posting order on
            # every process (their wire exchanges share one per-cid
            # channel, and two concurrently-running collectives would
            # interleave frames on it) and there is ONE round-advancing
            # code path, which records/replays the signature's frozen
            # wire plan (coll/nbc + coll/plan)
            self._ft_fastfail(op_name)
            from ..coll import nbc as _nbc

            return lambda comm_, *a, **k: _nbc.run_blocking(
                self, op_name, fn, (comm_,) + a, k)
        # steady-state dispatch (coll/plan): a signature seen before
        # fires its frozen plan — the interpreted decision path runs once
        # per (signature, cvar generation), not once per call
        from ..coll import plan as _plan

        if _sentinel.enabled:
            # contract sentinel: in-process collectives fold into the
            # comm's signature chain too (chain determinism, the
            # post-hoc journal record); spanning comms note inside
            # nbc.run_blocking where the args are bound
            def noted(comm_, *a, **k):
                _sentinel.note(self, op_name, a, k)
                return _plan.dispatch(comm_, op_name, fn, a, k)

            return noted
        return lambda comm_, *a, **k: _plan.dispatch(comm_, op_name, fn, a,
                                                     k)

    def _run_serialized(self, fn, *args, **kw):
        """Run ``fn`` in the comm's collective posting order, blocking:
        fire + wait through the progress engine on spanning comms, a
        direct call otherwise."""
        if not self.spans_processes:
            return fn(*args, **kw)
        from ..coll import nbc as _nbc

        return _nbc.run_blocking(
            self, getattr(fn, "__name__", "serialized"), fn, args, kw)

    def _submit_serialized(self, fn, *args, **kw):
        """Nonblocking run of ``fn`` in the comm's collective posting
        order: returns a Request backed by a schedule posted to the
        progress engine."""
        from ..coll import nbc as _nbc

        return _nbc.submit(self, getattr(fn, "__name__", "serialized"),
                           fn, args, kw)

    def _async(self, value):
        """Wrap work already enqueued on this comm's device as a Request
        carrying ``value`` (see coll/nbc)."""
        from ..coll import nbc as _nbc

        return _nbc.async_request(value, self.device)

    def _buf(self, x):
        """The rank-stacked buffer on this comm's device (pair-op
        (values, indices) tuples convert element-wise)."""
        from ..coll.driver import as_rank_buffer

        if isinstance(x, tuple):
            return tuple(as_rank_buffer(e, self.device) for e in x)
        return as_rank_buffer(x, self.device)

    def allreduce(self, x, op=None):
        from .. import ops as ops_mod

        return self._coll("allreduce")(self, self._buf(x), op or ops_mod.SUM)

    def reduce(self, x, op=None, root: int = 0):
        from .. import ops as ops_mod

        return self._coll("reduce")(self, self._buf(x), op or ops_mod.SUM,
                                    root)

    def bcast(self, x, root: int = 0):
        return self._coll("bcast")(self, self._buf(x), root)

    def allgather(self, x):
        return self._coll("allgather")(self, self._buf(x))

    def gather(self, x, root: int = 0):
        return self._coll("gather")(self, self._buf(x), root)

    def scatter(self, x, root: int = 0):
        return self._coll("scatter")(self, self._buf(x), root)

    def reduce_scatter_block(self, x, op=None):
        from .. import ops as ops_mod

        return self._coll("reduce_scatter_block")(self, self._buf(x),
                                                  op or ops_mod.SUM)

    def alltoall(self, x):
        return self._coll("alltoall")(self, self._buf(x))

    def scan(self, x, op=None):
        from .. import ops as ops_mod

        return self._coll("scan")(self, self._buf(x), op or ops_mod.SUM)

    def exscan(self, x, op=None):
        from .. import ops as ops_mod

        return self._coll("exscan")(self, self._buf(x), op or ops_mod.SUM)

    def barrier(self) -> None:
        self._coll("barrier")(self)

    # -- nonblocking collectives (libnbc analogue; coll/nbc.py) ------------
    # Dispatch enqueues the collective on the current CUDA stream and
    # returns a Request completed by an event behind it; a seen signature
    # replays its frozen plan.
    def _icoll(self, name: str, *args, **kw):
        from ..coll import nbc as _nbc

        return _nbc.icoll(self, name, args, kw)

    def iallreduce(self, x, op=None):
        from .. import ops as ops_mod

        return self._icoll("allreduce", self._buf(x), op or ops_mod.SUM)

    def ireduce(self, x, op=None, root: int = 0):
        from .. import ops as ops_mod

        return self._icoll("reduce", self._buf(x), op or ops_mod.SUM, root)

    def ibcast(self, x, root: int = 0):
        return self._icoll("bcast", self._buf(x), root)

    def iallgather(self, x):
        return self._icoll("allgather", self._buf(x))

    def igather(self, x, root: int = 0):
        return self._icoll("gather", self._buf(x), root)

    def iscatter(self, x, root: int = 0):
        return self._icoll("scatter", self._buf(x), root)

    def ireduce_scatter_block(self, x, op=None):
        from .. import ops as ops_mod

        return self._icoll("reduce_scatter_block", self._buf(x),
                           op or ops_mod.SUM)

    def ireduce_scatter(self, x, recvcounts, op=None):
        from .. import ops as ops_mod

        return self._icoll("reduce_scatter", x, recvcounts,
                           op or ops_mod.SUM)

    def ialltoall(self, x):
        return self._icoll("alltoall", self._buf(x))

    def iscan(self, x, op=None):
        from .. import ops as ops_mod

        return self._icoll("scan", self._buf(x), op or ops_mod.SUM)

    def iexscan(self, x, op=None):
        from .. import ops as ops_mod

        return self._icoll("exscan", self._buf(x), op or ops_mod.SUM)

    def ialltoallv(self, sendbufs, sendcounts):
        return self._icoll("alltoallv", sendbufs, sendcounts)

    def iallgatherv(self, sendbufs):
        return self._icoll("allgatherv", sendbufs)

    # -- persistent collectives (MPI-4 *_init; coll/nbc.persistent) --------
    # The plan — resolved dispatch entry, op object, bound buffer — is
    # built ONCE here; Request.start() fires it against the buffer's
    # CURRENT contents each time without blocking.
    def allreduce_init(self, x, op=None):
        from .. import ops as ops_mod
        from ..coll import nbc as _nbc

        return _nbc.persistent(self, "allreduce", (x, op or ops_mod.SUM))

    def bcast_init(self, x, root: int = 0):
        from ..coll import nbc as _nbc

        return _nbc.persistent(self, "bcast", (x, root))

    def allgather_init(self, x):
        from ..coll import nbc as _nbc

        return _nbc.persistent(self, "allgather", (x,))

    def reduce_scatter_init(self, x, recvcounts, op=None):
        from .. import ops as ops_mod
        from ..coll import nbc as _nbc

        return _nbc.persistent(self, "reduce_scatter",
                               (x, recvcounts, op or ops_mod.SUM))

    def alltoall_init(self, x):
        from ..coll import nbc as _nbc

        return _nbc.persistent(self, "alltoall", (x,))

    def barrier_init(self):
        from ..coll import nbc as _nbc

        return _nbc.persistent(self, "barrier", ())

    def ibarrier(self):
        """Nonblocking barrier: returns before the barrier completes; its
        Request completes when every rank's work queued before it has
        finished (an event on the comm's device, see coll/nbc)."""
        from ..coll import nbc as _nbc

        return _nbc.ibarrier(self)

    # -- small-message fusion (coll/fusion.py) -----------------------------
    def fusion_buffer(self):
        """This communicator's small-message fusion buffer (Horovod
        fusion-buffer / BTL-coalescing analogue): allreduces below
        ``coll_fusion_threshold`` pack into one collective per (op,
        dtype). Created lazily, one per comm, under a module lock so a
        racing first use cannot orphan an instance."""
        fb = getattr(self, "_fusion_buffer", None)
        if fb is None:
            from ..coll.fusion import FusionBuffer

            with _fusion_create_lock:
                fb = getattr(self, "_fusion_buffer", None)
                if fb is None:
                    fb = FusionBuffer(self)
                    self._fusion_buffer = fb
        return fb

    def fused_allreduce(self, x, op=None):
        """Allreduce through the fusion buffer: small tensors coalesce
        with other submissions (flush with
        ``comm.fusion_buffer().flush()`` or the handle's ``result()``);
        large ones dispatch immediately. Returns a
        :class:`~..coll.fusion.FusedHandle`."""
        return self.fusion_buffer().allreduce(x, op)

    # -- v-variant collectives (per-rank counts; ragged host edge) ---------
    def alltoallv(self, sendbufs, sendcounts):
        """MPI_Alltoallv: ``sendbufs[i]`` holds rank i's chunks for
        ranks 0..n-1 back to back, ``sendcounts[i][j]`` elements for
        rank j. Returns ``recv[i]`` = chunks from each source, in
        source order."""
        return self._coll("alltoallv")(self, sendbufs, sendcounts)

    def allgatherv(self, sendbufs):
        """MPI_Allgatherv: ragged per-rank buffers, concatenated in
        rank order (identical on all ranks: returned once)."""
        return self._coll("allgatherv")(self, sendbufs)

    def gatherv(self, sendbufs, root: int = 0):
        return self._coll("gatherv")(self, sendbufs, root)

    def scatterv(self, sendbuf, counts, root: int = 0):
        """MPI_Scatterv: root's buffer split into counts[i] elements
        per rank; returns one tensor per rank."""
        return self._coll("scatterv")(self, sendbuf, counts, root)

    def reduce_scatter(self, x, recvcounts, op=None):
        """General MPI_Reduce_scatter with per-rank recv counts."""
        from .. import ops as ops_mod

        return self._coll("reduce_scatter")(
            self, x, recvcounts, op or ops_mod.SUM
        )

    # -- point-to-point (dispatched through the selected PML engine) -------
    @property
    def pml(self):
        """Per-comm PML engine, installed on first use
        (mca_pml_base_select analogue)."""
        eng = getattr(self, "_pml", None)
        if eng is None:
            self._check_alive()
            if self.submesh is None:
                raise MPIError(
                    ErrorCode.ERR_COMM,
                    f"{self.name} has no members on this controller "
                    "process — its operations can only be invoked on "
                    "the processes that own its ranks",
                )
            from ..p2p import pml as pml_mod

            eng = pml_mod.comm_select(self)
            self._pml = eng
        return eng

    def isend(self, data, dest: int, tag: int = 0, *, rank: int, **kw):
        """Nonblocking send issued by ``rank`` (driver mode: the acting
        rank is explicit because one controller plays every rank)."""
        self._check_usable()
        return self.pml.isend(data, dest, tag, src=rank, **kw)

    def send(self, data, dest: int, tag: int = 0, *, rank: int, **kw):
        self._check_usable()
        return self.pml.send(data, dest, tag, src=rank, **kw)

    def irecv(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_usable()
        return self.pml.irecv(source, tag, dst=rank)

    def recv(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_usable()
        return self.pml.recv(source, tag, dst=rank)

    def iprobe(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_usable()
        return self.pml.iprobe(source, tag, dst=rank)

    def improbe(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_usable()
        return self.pml.improbe(source, tag, dst=rank)

    def mrecv(self, message, *, rank: int):
        self._check_usable()
        return self.pml.mrecv(message, dst=rank)

    def send_init(self, data, dest: int, tag: int = 0, *, rank: int):
        self._check_usable()
        return self.pml.send_init(data, dest, tag, src=rank)

    def recv_init(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_usable()
        return self.pml.recv_init(source, tag, dst=rank)

    def sendrecv(self, sendbufs, dests, sendtag: int = 0,
                 sources=None, recvtag: int = -1):
        """MPI_Sendrecv, driver mode: EVERY rank's exchange in one call
        (like split's per-rank vectors) — all sends post first, then
        all recvs complete, which is what makes it deadlock-free. A
        per-rank blocking sendrecv cannot work under a single
        controller: rank 0's recv would block before rank 1 ever ran.

        sendbufs/dests (and optional sources): sequences of length
        ``size``. Returns (values, statuses) lists.
        """
        self._check_usable()
        if self.spans_processes:
            raise MPIError(
                ErrorCode.ERR_NOT_AVAILABLE,
                "driver-mode sendrecv acts as every rank at once; on a "
                "communicator spanning controller processes use "
                "per-rank isend/recv (each process acts only as its "
                "local ranks)",
            )
        n = self.size
        if (len(sendbufs) != n or len(dests) != n
                or (sources is not None and len(sources) != n)):
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"sendrecv needs {n} sendbufs/dests/sources "
                "(one per rank)",
            )
        sreqs = [
            self.pml.isend(sendbufs[r], dests[r], sendtag, src=r)
            for r in range(n)
        ]
        values, statuses = [], []
        for r in range(n):
            src = sources[r] if sources is not None else -1
            v, st = self.pml.recv(src, recvtag, dst=r)
            values.append(v)
            statuses.append(st)
        for sr in sreqs:
            sr.wait()
        return values, statuses

    def __repr__(self) -> str:
        return f"Communicator({self.name}, cid={self.cid}, size={self.size})"


_MISSING = object()
_keyval_table: Dict[int, Keyval] = {}


def create_keyval(copy_fn=None, delete_fn=None, extra_state=None) -> Keyval:
    kv = Keyval(copy_fn, delete_fn, extra_state)
    _keyval_table[kv.id] = kv
    return kv


def free_keyval(kv: Keyval) -> None:
    _keyval_table.pop(kv.id, None)
