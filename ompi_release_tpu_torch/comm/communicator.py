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

Ported so far: WORLD/SELF, dup/create/split/free, attributes,
errhandlers, the blocking collectives, which call the installed
``c_coll`` table directly, and point-to-point through the per-comm PML
engine (driver mode: the acting rank is the keyword ``rank=``).
Nonblocking and persistent collectives and the fault-tolerance hooks
come with later slices.

CID allocation: under a single controller the reference's agreement
(``comm_cid.c``) reduces to a deterministic monotone counter.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..mca import pvar
from ..utils import output
from ..utils.errors import Errhandler, ErrorCode, MPIError, ERRORS_ARE_FATAL
from .group import Group, UNDEFINED

_log = output.stream("comm")
_cid_counter = itertools.count(0)
_cid_lock = threading.Lock()
_comm_registry: Dict[int, "Communicator"] = {}

_comm_count = pvar.counter("comm_active_count", "live communicators")


def _next_cid() -> int:
    with _cid_lock:
        return next(_cid_counter)


def clear_comm_registry() -> None:
    """Finalize-time teardown: mark every live communicator freed (so
    stale handles raise instead of silently working)."""
    for c in list(_comm_registry.values()):
        c._freed = True
        _comm_count.add(-1)
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
    def __init__(self, runtime, group: Group, *, name: str = "",
                 parent: Optional["Communicator"] = None) -> None:
        self.runtime = runtime
        self.group = group
        self.cid = _next_cid()
        self.name = name or f"comm{self.cid}"
        self.errhandler: Errhandler = (
            parent.errhandler if parent else ERRORS_ARE_FATAL
        )
        self._attrs: Dict[int, Any] = {}
        self._freed = False
        #: the device holding the comm's rank-stacked buffers: its
        #: first rank's
        self.device: torch.device = \
            runtime.mesh.devices.reshape(-1)[group.world_ranks[0]]

        # per-comm collective table (c_coll analogue), installed at
        # creation time exactly like coll_base_comm_select
        from ..coll import base as coll_base

        self.c_coll = coll_base.comm_select(self)
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

    # -- construction ------------------------------------------------------
    def dup(self, name: str = "") -> "Communicator":
        self._check_alive()
        c = Communicator(self.runtime, self.group,
                         name=name or f"dup({self.name})", parent=self)
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

    def free(self) -> None:
        self._check_alive()
        for kv_id, value in list(self._attrs.items()):
            kv = _keyval_table.get(kv_id)
            if kv and kv.delete_fn:
                kv.delete_fn(self, kv, value, kv.extra_state)
        self._attrs.clear()
        _comm_registry.pop(self.cid, None)
        self._freed = True
        _comm_count.add(-1)

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

    # -- collectives (dispatch through the installed c_coll table) ---------
    def _coll(self, op_name: str) -> Callable:
        self._check_alive()
        fn = self.c_coll.get(op_name)
        if fn is None:
            raise MPIError(ErrorCode.ERR_INTERN,
                           f"no {op_name} implementation installed on "
                           f"{self.name}")
        return fn

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

    def reduce_scatter_block(self, x, op=None):
        from .. import ops as ops_mod

        return self._coll("reduce_scatter_block")(self, self._buf(x),
                                                  op or ops_mod.SUM)

    def alltoall(self, x):
        return self._coll("alltoall")(self, self._buf(x))

    def barrier(self) -> None:
        self._coll("barrier")(self)

    # -- point-to-point (dispatched through the selected PML engine) -------
    @property
    def pml(self):
        """Per-comm PML engine, installed on first use
        (mca_pml_base_select analogue)."""
        eng = getattr(self, "_pml", None)
        if eng is None:
            self._check_alive()
            from ..p2p import pml as pml_mod

            eng = pml_mod.comm_select(self)
            self._pml = eng
        return eng

    def isend(self, data, dest: int, tag: int = 0, *, rank: int, **kw):
        """Nonblocking send issued by ``rank`` (driver mode: the acting
        rank is explicit because one controller plays every rank)."""
        self._check_alive()
        return self.pml.isend(data, dest, tag, src=rank, **kw)

    def send(self, data, dest: int, tag: int = 0, *, rank: int, **kw):
        self._check_alive()
        return self.pml.send(data, dest, tag, src=rank, **kw)

    def irecv(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_alive()
        return self.pml.irecv(source, tag, dst=rank)

    def recv(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_alive()
        return self.pml.recv(source, tag, dst=rank)

    def iprobe(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_alive()
        return self.pml.iprobe(source, tag, dst=rank)

    def improbe(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_alive()
        return self.pml.improbe(source, tag, dst=rank)

    def mrecv(self, message, *, rank: int):
        self._check_alive()
        return self.pml.mrecv(message, dst=rank)

    def send_init(self, data, dest: int, tag: int = 0, *, rank: int):
        self._check_alive()
        return self.pml.send_init(data, dest, tag, src=rank)

    def recv_init(self, source: int = -1, tag: int = -1, *, rank: int):
        self._check_alive()
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
        self._check_alive()
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
