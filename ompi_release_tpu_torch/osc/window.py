"""MPI_Win windows over device tensors, in-process half.

Counterpart of ``ompi_release_tpu/osc/window.py`` (the reference's osc
framework, ``ompi/mca/osc/osc.h:205-338``: put/get/accumulate/CAS/
fetch-op and fence/PSCW/lock epochs), for one controller playing every
rank:

- A window is one tensor with a leading rank axis on the comm's device,
  row i being rank i's memory (the MPI_Win_allocate model). The tensor
  keeps ONE address for the window's life and every epoch close writes
  it in place: a frozen epoch plan (``osc/plan.py``) is a CUDA graph on
  the card, and a graph can only write memory whose address does not
  move.
- JAX arrays are immutable, so whatever the JAX window hands out never
  changes under a later epoch. The port keeps that: :meth:`read`,
  ``shared_query``, ``WIN_BASE`` and a get's ``request.value`` are
  snapshots (copies), never views of the live storage.
- RMA calls queue during an epoch; closing it (fence, unlock, complete,
  flush) applies them in submission order (the MPI completion rule, the
  osc/rdma "aggregate and issue at sync" strategy). A payload is copied
  when the call queues it, as ``jnp.asarray`` does, with the same
  64-bit-to-32-bit conversion of host values (``utils/arrays.py``).
- get/get_accumulate/fetch_and_op/compare_and_swap return Requests whose
  values materialize at epoch close.

The interpreted close (:meth:`Window._run_epoch_program`) keeps the
reference's program cache: one close program per (op count padded to a
power of two, block, dtype, ordered distinct branch keys, scalar-payload
mode), counted by ``osc_epoch_programs``. The program applies each op
through :meth:`Window._branch_fn`, which updates the target's row in
place (the reference's functional ``(cur, pay) -> new`` written into
the row: the same elementwise ops on the same bits). Accumulates apply
``op(cur, pay)`` directly, outside the op framework, as the reference
does. A scalar REPLACE accumulate broadcasts to the row (the
reference's scalar-broadcast fix). Payloads cast to the window's dtype (a float into an
int32 window truncates toward zero, as ``astype`` does).

Epoch rules enforced (``ompi/win/win.c`` access-epoch checks): RMA
outside any epoch raises; fence/lock/PSCW cannot be mixed. On a
communicator spanning controller processes, ``win_create`` and
``win_allocate`` build the wire window (``osc/wire_win.py``): this
process stores its LOCAL members' slices, and RMA to a target in another
process ships to that target's home at synchronization.
"""

from __future__ import annotations

import enum
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..coll import plan as _coll_plan
from ..mca import pvar
from ..ops.op import Op, REPLACE, SUM
from ..request.request import Request, Status
from ..utils.arrays import copy_to, torch_dtype
from ..utils.errors import ErrorCode, MPIError

_epoch_count = pvar.counter("osc_epochs", "RMA epochs closed")
_rma_ops = pvar.counter("osc_rma_ops", "RMA operations issued")
_epoch_programs = pvar.counter(
    "osc_epoch_programs", "distinct epoch-close programs"
)
_epoch_dispatches = pvar.counter(
    "osc_epoch_dispatches", "epoch-close program invocations"
)

#: epoch-close programs, keyed by (op count padded to a power of two,
#: block, dtype, ordered distinct (kind, op, indexed) branches,
#: scalar-payload mode) — padding keeps the cache O(log n) per branch
#: set across varying epoch lengths
_program_cache: Dict[Tuple, Callable] = {}

#: every close's device work, and every epoch-plan capture, runs under
#: the port's capture lock (``coll/plan.py``): threads do close epochs
#: concurrently (SHMEM lock contention), and a CUDA-graph capture counts
#: the launches made while it runs as its graph's, so no other thread's
#: close may launch during one
_dispatch_lock = _coll_plan.capture_lock

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2


class _EpochKind(enum.Enum):
    NONE = "none"
    FENCE = "fence"
    LOCK = "lock"
    PSCW = "pscw"


class _PendingOp:
    __slots__ = ("kind", "target", "data", "op", "request", "compare",
                 "index", "status_rank")

    def __init__(self, kind, target, data=None, op=None, request=None,
                 compare=None, index=None, status_rank=None) -> None:
        self.kind = kind
        self.target = target
        self.data = data
        self.op = op
        self.request = request
        self.compare = compare
        # flat element offset within the target slot (MPI target_disp
        # for single-element ops); None = whole-slot operation
        self.index = index
        # the COMM rank a read's Status reports when ``target`` was
        # remapped to a storage row (spanning windows)
        self.status_rank = status_rank

    @property
    def source(self) -> int:
        return self.target if self.status_rank is None else self.status_rank


# predefined window attributes (mpi.h MPI_WIN_BASE..MPI_WIN_MODEL)
WIN_BASE = "win_base"
WIN_SIZE = "win_size"
WIN_DISP_UNIT = "win_disp_unit"
WIN_CREATE_FLAVOR = "win_create_flavor"
WIN_MODEL = "win_model"
# create flavors (MPI_WIN_FLAVOR_*)
FLAVOR_CREATE = 1
FLAVOR_ALLOCATE = 2
FLAVOR_DYNAMIC = 3
FLAVOR_SHARED = 4
# memory models: one address space with epoch-close visibility =
# MPI_WIN_UNIFIED semantics
MODEL_SEPARATE = 1
MODEL_UNIFIED = 2


def _elem(pay: torch.Tensor, idx: int) -> torch.Tensor:
    """Element ``idx`` of a payload broadcast over the slot: a scalar is
    every element."""
    if pay.dim() == 0:
        return pay
    return pay[tuple(int(i) for i in _unravel(idx, pay.shape))]


def _unravel(idx: int, shape) -> List[int]:
    out = []
    for d in reversed(shape):
        idx, r = divmod(idx, d)
        out.append(r)
    return out[::-1]


def _cast(x: Optional[torch.Tensor], dtype: torch.dtype,
          shape: Tuple[int, ...]) -> Optional[torch.Tensor]:
    """A payload in the window's dtype, broadcast over the slot unless it
    is a scalar."""
    if x is None:
        return None
    x = x.to(dtype)
    return x if x.dim() == 0 else torch.broadcast_to(x, shape)


def _pre_op_read(slot: torch.Tensor, index: Optional[int]) -> torch.Tensor:
    """What a read request returns: a copy of the slot before the op, or
    of its one element for an indexed op."""
    if index is None:
        return slot.clone()
    return slot.reshape(-1)[index].clone()


class Window:
    def __init__(self, comm, base, name: str = "", *,
                 _owned: bool = False) -> None:
        """``base``: the per-rank buffers, copied onto the comm's device
        (``_owned``: a fresh contiguous tensor there, taken as is)."""
        if getattr(comm, "spans_processes", False):
            # comm.device holds only the LOCAL members' rows on a
            # spanning comm: the wire window stores those and ships
            # remote RMA to its home (osc/wire_win.py)
            raise MPIError(
                ErrorCode.ERR_WIN,
                f"{comm.name} spans controller processes; construct "
                "windows through win_create/win_allocate (the wire "
                "window), not Window() directly",
            )
        if base.shape[0] != comm.size:
            raise MPIError(
                ErrorCode.ERR_WIN,
                f"window base leading axis {base.shape[0]} != comm size "
                f"{comm.size}",
            )
        self._init_state(comm, base, name, _owned)

    def _init_state(self, comm, base, name: str, owned: bool) -> None:
        """Shared field setup (the spanning wire window, whose leading
        axis is its LOCAL members, reuses it)."""
        self.comm = comm
        self.name = name or f"win{id(self):x}"
        #: the window's memory: one address for its life (plans' graphs
        #: write it in place)
        self._data = base if owned else \
            copy_to(base, comm.device).contiguous()
        self._epoch = _EpochKind.NONE
        self._locked: Dict[int, int] = {}  # target -> lock type
        self._pending: List[_PendingOp] = []
        # one controller, possibly many threads (a producer thread
        # posting AMOs while a waiter polls with get/flush): the pending
        # queue and its apply must be atomic or concurrent flushes lose
        # ops
        self._op_lock = threading.RLock()
        self._group_exposed = None  # PSCW exposure group
        self._freed = False
        self._flavor = FLAVOR_CREATE  # constructors override
        self._attrs: Dict[int, object] = {}  # user keyvals (win_keyval)
        # frozen per-epoch-signature access plans (osc/plan), each with
        # its graph and static buffers on the card, and the spanning
        # window's frozen remote-batch frames; evicted at free()
        self._access_plans: Dict[Tuple, Any] = {}
        self._batch_templates: Dict[Tuple, Any] = {}

    # -- queries -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    def read(self) -> torch.Tensor:
        """Local loads of the whole window (valid outside access epochs
        or after a flush; one controller sees every rank's slice): a
        snapshot, unchanged by later epochs."""
        return self._data.clone()

    def _read_row(self, rank: int) -> torch.Tensor:
        """A snapshot of one rank's slice."""
        return self._data[rank].clone()

    def set_attr(self, keyval, value) -> None:
        """MPI_Win_set_attr with a user keyval (the same Keyval objects
        ``comm.create_keyval`` mints — ``win.c`` shares one attribute
        machinery across comm/win/datatype)."""
        if self._freed:
            raise MPIError(ErrorCode.ERR_WIN, f"{self.name} freed")
        self._attrs[keyval.id] = value

    def delete_attr(self, keyval) -> None:
        from ..comm.communicator import _keyval_table

        kv = _keyval_table.get(keyval.id)
        value = self._attrs.pop(keyval.id, None)
        if kv is not None and kv.delete_fn is not None and value is not None:
            kv.delete_fn(self, kv, value, kv.extra_state)

    def get_attr(self, key):
        """MPI_Win_get_attr: predefined string attributes
        (``ompi/win/win.c`` WIN_BASE..WIN_MODEL) or a user Keyval;
        returns (found, value). WIN_SIZE / WIN_DISP_UNIT describe ONE
        rank's window (block bytes, element size). WIN_BASE is a
        snapshot of the whole (comm.size, ...) storage: one controller
        plays every rank, so "the local base" is ``base[rank]``."""
        if not isinstance(key, str):  # user keyval
            if key.id in self._attrs:
                return True, self._attrs[key.id]
            return False, None
        if key == WIN_BASE:
            return True, self.read()
        if key == WIN_SIZE:
            n = math.prod(self.shape)
            return True, int(n * self._data.element_size())
        if key == WIN_DISP_UNIT:
            return True, int(self._data.element_size())
        if key == WIN_CREATE_FLAVOR:
            return True, self._flavor
        if key == WIN_MODEL:
            return True, MODEL_UNIFIED
        return False, None

    def shared_query(self, rank: int):
        """MPI_Win_shared_query (``osc/sm``): (size_bytes, disp_unit,
        block) for ``rank``'s segment of a shared window. The block is a
        snapshot as of the call, as in the JAX package: re-query after a
        flush, the same discipline as :meth:`read`. ``rank=-1``
        (MPI_PROC_NULL convention) answers for the lowest rank."""
        if not getattr(self, "_shared", False):
            raise MPIError(
                ErrorCode.ERR_RMA_SHARED,
                f"{self.name} was not created by win_allocate_shared",
            )
        if rank == -1:
            rank = 0
        if not 0 <= rank < self.comm.size:
            raise MPIError(ErrorCode.ERR_RANK,
                           f"shared_query rank {rank} out of range")
        blk = self._read_row(rank)
        return int(blk.numel() * blk.element_size()), \
            int(blk.element_size()), blk

    # -- epoch state machine ----------------------------------------------
    def _require(self, *kinds: _EpochKind) -> None:
        if self._freed:
            raise MPIError(ErrorCode.ERR_WIN, f"{self.name} freed")
        if self._epoch not in kinds:
            raise MPIError(
                ErrorCode.ERR_RMA_SYNC,
                f"operation requires epoch {[k.value for k in kinds]}, "
                f"window is in '{self._epoch.value}'",
            )

    def fence(self, _barrier: bool = True) -> None:
        """Open/continue a fence epoch; applies queued ops (MPI fence
        both closes the previous access epoch and opens the next).
        ``_barrier=False`` is for composite windows (DynamicWindow) that
        fan one fence over many regions and barrier ONCE."""
        self._require(_EpochKind.NONE, _EpochKind.FENCE)
        self._apply_pending()
        self._epoch = _EpochKind.FENCE
        if _barrier:
            self.comm.barrier()

    def fence_end(self, _barrier: bool = True) -> None:
        """Final fence (MPI_MODE_NOSUCCEED): close the epoch."""
        self._require(_EpochKind.FENCE)
        self._apply_pending()
        self._epoch = _EpochKind.NONE
        if _barrier:
            self.comm.barrier()

    def lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        self._require(_EpochKind.NONE, _EpochKind.LOCK)
        if target in self._locked:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           f"target {target} already locked")
        self._locked[target] = lock_type
        self._epoch = _EpochKind.LOCK

    def lock_all(self) -> None:
        self._require(_EpochKind.NONE)
        for t in range(self.comm.size):
            self._locked[t] = LOCK_SHARED
        self._epoch = _EpochKind.LOCK

    def unlock(self, target: int) -> None:
        self._require(_EpochKind.LOCK)
        if target not in self._locked:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           f"target {target} not locked")
        self._apply_pending(only_target=target)
        del self._locked[target]
        if not self._locked:
            self._epoch = _EpochKind.NONE

    def unlock_all(self) -> None:
        self._require(_EpochKind.LOCK)
        self._apply_pending()
        self._locked.clear()
        self._epoch = _EpochKind.NONE

    def flush(self, target: int) -> None:
        """Complete pending ops to one target inside a passive epoch."""
        self._require(_EpochKind.LOCK)
        self._apply_pending(only_target=target)

    def flush_all(self) -> None:
        self._require(_EpochKind.LOCK)
        self._apply_pending()

    def flush_local(self, target: int) -> None:
        """MPI_Win_flush_local: local completion only. Payloads are
        copied when queued (reusable at once), so local completion is
        implied — but MPI still requires the epoch check, and completing
        remotely too is allowed (stronger)."""
        self.flush(target)

    def flush_local_all(self) -> None:
        self.flush_all()

    def sync(self) -> None:
        """MPI_Win_sync: synchronize public/private window copies. The
        window is MPI_WIN_UNIFIED with one storage tensor — there is no
        second copy to reconcile (get_attr WIN_MODEL)."""
        self._require(_EpochKind.FENCE, _EpochKind.LOCK,
                      _EpochKind.PSCW, _EpochKind.NONE)

    # PSCW (generalized active target)
    def post(self, group) -> None:
        """Exposure epoch: this window's slices may be targeted by the
        ranks of ``group`` (one state machine for every rank)."""
        self._require(_EpochKind.NONE)
        self._group_exposed = group
        self._epoch = _EpochKind.PSCW

    def start(self, group) -> None:
        self._require(_EpochKind.NONE, _EpochKind.PSCW)
        self._epoch = _EpochKind.PSCW

    def complete(self) -> None:
        """Close the access side of a PSCW epoch (MPI_Win_complete)."""
        self._require(_EpochKind.PSCW)
        self._apply_pending()
        self._epoch = _EpochKind.NONE

    def wait(self) -> None:
        """Close the exposure side (MPI_Win_wait). The single state
        machine conflates access/exposure, so wait() after the origin's
        complete() must succeed — it applies anything still pending and
        clears the exposure group. A bare start() access epoch has no
        exposure to wait on and is rejected."""
        if self._group_exposed is None:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           "wait() without a matching post()")
        if self._epoch is _EpochKind.PSCW:
            self._apply_pending()
            self._epoch = _EpochKind.NONE
        self._group_exposed = None

    def test(self) -> bool:
        """MPI_Win_test: nonblocking wait(). One controller: every
        origin's complete() has necessarily run by the time test() is
        reachable, so a posted exposure tests complete (and closes, like
        wait)."""
        if self._group_exposed is None:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           "test() without a matching post()")
        self.wait()
        return True

    def free(self) -> None:
        if self._pending:
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           "free with unsynchronized RMA operations")
        # MPI_Win_free runs the attribute delete callbacks for every
        # still-attached user keyval — the same shared attribute
        # machinery Communicator.free() drains (win.c keyval contract)
        from ..comm.communicator import _keyval_table

        for kv_id, value in list(self._attrs.items()):
            kv = _keyval_table.get(kv_id)
            if kv and kv.delete_fn:
                kv.delete_fn(self, kv, value, kv.extra_state)
        self._attrs.clear()
        # a freed window's plans, their graphs and static buffers die
        # with it
        self._access_plans.clear()
        self._batch_templates.clear()
        self._freed = True

    # -- RMA operations ----------------------------------------------------
    def _payload(self, x, target: int) -> torch.Tensor:
        """The call-time copy of a payload bound for ``target``, on the
        window's device."""
        return copy_to(x, self._data.device)

    def _queue(self, op: _PendingOp) -> Optional[Request]:
        self._require(_EpochKind.FENCE, _EpochKind.LOCK, _EpochKind.PSCW)
        if (self._epoch is _EpochKind.LOCK
                and op.target not in self._locked):
            raise MPIError(ErrorCode.ERR_RMA_SYNC,
                           f"target {op.target} not locked")
        if not 0 <= op.target < self.comm.size:
            raise MPIError(ErrorCode.ERR_RANK,
                           f"RMA target {op.target} out of range")
        if op.index is not None:
            slot_elems = math.prod(self.shape)
            if not 0 <= op.index < slot_elems:
                raise MPIError(
                    ErrorCode.ERR_ARG,
                    f"RMA element index {op.index} out of range for "
                    f"slot of {slot_elems} elements",
                )
        _rma_ops.add()
        with self._op_lock:
            self._pending.append(op)
        return op.request

    def _rma_request(self, target: int) -> Request:
        """A Request completable by ``wait()`` ALONE: its block_fn
        flushes the op's target (``_apply_pending(only_target)``), the
        per-op completion MPI 3.1 gives request-based RMA inside a
        passive epoch (``osc.h:341-366``). Flushing the whole target is
        stronger than one op — allowed, same-origin ordering makes it
        indistinguishable."""
        return Request(
            block_fn=lambda: self._apply_pending(only_target=target)
        )

    def put(self, data, target: int, index: Optional[int] = None) -> None:
        """Put a whole slot, or (``index`` given) a single element at a
        flat offset within the slot (MPI target_disp addressing)."""
        self._queue(_PendingOp("put", target, self._payload(data, target),
                               REPLACE, index=index))

    def get(self, target: int) -> Request:
        req = self._rma_request(target)
        self._queue(_PendingOp("get", target, request=req))
        return req

    def accumulate(self, data, target: int, op: Op = SUM,
                   index: Optional[int] = None) -> None:
        self._queue(_PendingOp("acc", target, self._payload(data, target),
                               op, index=index))

    def get_accumulate(self, data, target: int, op: Op = SUM,
                       index: Optional[int] = None) -> Request:
        req = self._rma_request(target)
        self._queue(_PendingOp("get_acc", target,
                               self._payload(data, target), op, req,
                               index=index))
        return req

    def fetch_and_op(self, value, target: int, op: Op = SUM,
                     index: Optional[int] = None) -> Request:
        """MPI_Fetch_and_op: single element when ``index`` is given (the
        MPI call is defined on ONE element at target_disp — ``osc.h:
        310``); whole-slot elementwise otherwise."""
        return self.get_accumulate(value, target, op, index=index)

    # -- request-based RMA (MPI-3 MPI_Rput/Rget/Raccumulate) ---------------
    # Each returns a Request completable INSIDE the epoch (wait = per-op
    # flush semantics, osc.h:341-366), carrying the pre-op slice.
    def rput(self, data, target: int,
             index: Optional[int] = None) -> Request:
        req = self._rma_request(target)
        self._queue(_PendingOp("put", target, self._payload(data, target),
                               REPLACE, request=req, index=index))
        return req

    def raccumulate(self, data, target: int, op: Op = SUM,
                    index: Optional[int] = None) -> Request:
        req = self._rma_request(target)
        self._queue(_PendingOp("acc", target, self._payload(data, target),
                               op, request=req, index=index))
        return req

    def rget(self, target: int) -> Request:
        return self.get(target)

    def rget_accumulate(self, data, target: int, op: Op = SUM,
                        index: Optional[int] = None) -> Request:
        return self.get_accumulate(data, target, op, index=index)

    def compare_and_swap(self, value, compare, target: int,
                         index: Optional[int] = None) -> Request:
        """MPI_Compare_and_swap. With ``index``, true single-element CAS
        at a flat offset (MPI semantics, ``osc.h:324``); without, an
        elementwise CAS over the whole slot (a documented whole-block
        extension)."""
        req = self._rma_request(target)
        self._queue(
            _PendingOp("cas", target, self._payload(value, target), None, req,
                       compare=self._payload(compare, target), index=index)
        )
        return req

    # -- application -------------------------------------------------------
    @staticmethod
    def _branch_key(p: _PendingOp) -> Tuple[str, Any, bool]:
        indexed = p.index is not None
        if p.kind in ("acc", "get_acc"):
            # the op OBJECT (frozen, hashable), not its name: branch keys
            # feed the program cache sig, and a same-named op with a
            # different combiner must get its own branch
            return ("acc", p.op, indexed)
        return (p.kind, "", indexed)

    @staticmethod
    def _branch_fn(key: Tuple[str, Any, bool], op: Optional[Op]
                   ) -> Callable:
        """One branch: ``(slot, payload, compare, idx)`` applies the op
        to ``slot``, the target's live row, in place. ``payload`` and
        ``compare`` are in the window's dtype, 0-d (scalar payloads) or
        broadcast over the slot; indexed branches operate on the single
        element at flat offset ``idx``."""
        kind, _, indexed = key

        if kind in ("noop", "get"):
            return lambda slot, pay, cmp, idx: None
        if kind == "put":
            if indexed:
                def put_elem(slot, pay, cmp, idx):
                    slot.reshape(-1)[idx] = _elem(pay, idx)
                return put_elem
            return lambda slot, pay, cmp, idx: slot.copy_(pay)
        if kind == "acc":
            if indexed:
                def acc_elem(slot, pay, cmp, idx):
                    flat = slot.reshape(-1)
                    flat[idx] = op(flat[idx], _elem(pay, idx))
                return acc_elem
            # ops that ignore cur (REPLACE) return the payload as-is — a
            # scalar in scalar-payload epochs — so pin the result to the
            # slot's shape (the reference's scalar-broadcast fix)
            return lambda slot, pay, cmp, idx: slot.copy_(
                torch.broadcast_to(op(slot, pay), slot.shape))
        # cas
        if indexed:
            def cas_elem(slot, pay, cmp, idx):
                flat = slot.reshape(-1)
                old = flat[idx]
                flat[idx] = torch.where(old == _elem(cmp, idx),
                                        _elem(pay, idx), old)
            return cas_elem
        return lambda slot, pay, cmp, idx: slot.copy_(
            torch.where(slot == cmp, pay, slot))

    def _apply_pending(self, only_target: Optional[int] = None) -> None:
        """Apply queued ops in submission order (MPI same-origin
        ordering; the single queue is globally ordered). A repeated
        epoch replays its frozen access plan (``osc/plan.py``); the
        first close of a new signature runs the interpreted program."""
        with self._op_lock:
            self._apply_pending_locked(only_target)

    def _take_pending(self, only_target: Optional[int] = None
                      ) -> List[_PendingOp]:
        """Atomically remove (and return) the ops this close covers."""
        if only_target is None:
            todo, self._pending = self._pending, []
        else:
            todo = [p for p in self._pending if p.target == only_target]
            self._pending = [
                p for p in self._pending if p.target != only_target
            ]
        return todo

    def _apply_pending_locked(self, only_target: Optional[int] = None
                              ) -> None:
        if not self._pending:
            return
        _epoch_count.add()
        todo = self._take_pending(only_target)
        if not todo:
            return
        t0 = time.perf_counter()
        from . import plan as _osc_plan

        if not _osc_plan.close_epoch(self, todo, t0):
            self._run_epoch_program(todo, _t0=t0)

    def _run_epoch_program(self, todo: List[_PendingOp],
                           _t0: Optional[float] = None) -> None:
        """Apply ``todo`` through the signature's cached close program
        and complete its read requests. Callers hold ``_op_lock``.
        ``_t0`` (close-entry clock) feeds the shared orchestration timer
        so the interpreted and planned paths are measured over identical
        spans."""
        if not todo:
            return
        block = self.shape
        # Scalar-payload epochs (the common AMO pattern: many scalar
        # accumulates/CAS on a large window) keep payloads scalar: each
        # broadcasts inside the op
        scalar_mode = all(
            (p.data is None or p.data.dim() == 0)
            and (p.compare is None or p.compare.dim() == 0)
            for p in todo
        ) and block != ()

        branch_keys: List[Tuple[str, Any, bool]] = []
        branch_fns = []
        codes: List[int] = []
        for p in todo:
            k = self._branch_key(p)
            if k not in branch_keys:
                branch_keys.append(k)
                branch_fns.append(self._branch_fn(k, p.op))
            codes.append(branch_keys.index(k))
        # The reference pads the op count to the next power of two with
        # no-op steps so its program cache holds O(log n) programs per
        # branch set; the key keeps that (and the no-op branch), the
        # program runs the real steps only
        n = len(todo)
        n_pad = 1 << (n - 1).bit_length() if n > 1 else 1
        noop_key = ("noop", "", False)
        if noop_key not in branch_keys:
            branch_keys.append(noop_key)
            branch_fns.append(self._branch_fn(noop_key, None))
        sig = (n_pad, block, str(self.dtype), tuple(branch_keys),
               scalar_mode)
        dtype = self.dtype
        steps = [(code, p.target, _cast(p.data, dtype, block),
                  _cast(p.compare, dtype, block), p.index,
                  p.request is not None)
                 for code, p in zip(codes, todo)]
        if _t0 is not None:
            from . import plan as _osc_plan

            _osc_plan.orch_add(time.perf_counter() - _t0)
        with _dispatch_lock:
            prog = _program_cache.get(sig)
            if prog is None:
                _epoch_programs.add()
                prog = _program_cache[sig] = _close_program(branch_fns)
            _epoch_dispatches.add()
            reads = prog(self._data, steps)
        ri = iter(reads)
        for p in todo:
            if p.request is not None:
                p.request.complete(value=next(ri),
                                   status=Status(source=p.source))


def _close_program(branch_fns: List[Callable]) -> Callable:
    """One signature's close program: ``(data, steps) -> reads`` applies
    each (code, target, payload, compare, index, wants_read) step in
    order through its branch and returns the pre-op reads."""
    def close(data, steps):
        reads = []
        for code, tgt, pay, cmp, idx, wants in steps:
            slot = data[tgt]
            if wants:
                reads.append(_pre_op_read(slot, idx))
            branch_fns[code](slot, pay, cmp, 0 if idx is None else idx)
        return reads
    return close


def win_create(comm, base, name: str = "") -> Window:
    """MPI_Win_create: wrap per-rank buffers (leading rank axis; one
    slice per LOCAL member on a spanning comm). The window copies them
    onto the comm's device, as the JAX package's ``device_put`` does."""
    if getattr(comm, "spans_processes", False):
        from .wire_win import WireWindow

        return WireWindow(comm, base, name)
    return Window(comm, base, name)


def win_allocate(comm, shape: Tuple[int, ...], dtype=torch.float32,
                 name: str = "") -> Window:
    """MPI_Win_allocate: fresh zeroed window, one ``shape`` block per
    rank (this process's LOCAL members' blocks on a spanning comm)."""
    if getattr(comm, "spans_processes", False):
        from .wire_win import WireWindow

        local_n = len(comm.local_comm_ranks)
        win = WireWindow(comm, torch.zeros(
            (local_n,) + tuple(shape), dtype=torch_dtype(dtype),
            device=comm.device), name, _owned=True)
    else:
        win = Window(comm, torch.zeros(
            (comm.size,) + tuple(shape), dtype=torch_dtype(dtype),
            device=comm.device), name, _owned=True)
    win._flavor = FLAVOR_ALLOCATE
    return win


def win_allocate_shared(comm, shape: Tuple[int, ...],
                        dtype=torch.float32, name: str = "") -> Window:
    """MPI_Win_allocate_shared (the ``osc/sm`` component's role): a
    window whose ranks' blocks are one CONTIGUOUS allocation, so
    neighbors can address each other's memory directly. The window
    carries :meth:`Window.shared_query`. The comm must live on one host:
    the check reads its members' endpoints' host identity."""
    if getattr(comm, "spans_processes", False):
        raise MPIError(
            ErrorCode.ERR_RMA_SHARED,
            "win_allocate_shared needs a process-local comm (device "
            "buffers cannot be shared across controller processes); "
            "split with split_type_shared first",
        )
    # direct attribute access ON PURPOSE: a rename in runtime/group must
    # surface as an AttributeError here, not silently turn the
    # multi-host safety gate vacuous
    members = set(comm.group.world_ranks)
    hosts = {ep.host for ep in comm.runtime.endpoints
             if ep.rank in members}
    if len(hosts) > 1:
        raise MPIError(
            ErrorCode.ERR_RMA_SHARED,
            f"win_allocate_shared needs a single-host comm "
            f"(got hosts {sorted(h or '?' for h in hosts)}); split "
            "with split_type_shared first",
        )
    win = win_allocate(comm, shape, dtype, name)
    win._shared = True
    win._flavor = FLAVOR_SHARED
    return win


class DynamicWindow:
    """MPI_Win_create_dynamic + MPI_Win_attach/detach (``ompi/mca/osc/
    rdma`` dynamic-flavor support): a window created EMPTY whose memory
    regions attach and detach while it lives.

    Each :meth:`attach` creates one uniform per-rank region (a fresh
    :class:`Window`) addressed by the returned region id. Epoch
    synchronization spans the WHOLE dynamic window: fence/lock_all/
    unlock_all/flush_all fan out to every attached region (one comm
    barrier per fence, not per region) and a region attached MID-EPOCH
    inherits the open epoch, as MPI_Win_attach requires. Per-region RMA
    goes through the owning region's queue. Detaching with queued
    unsynchronized ops is refused, and free() refuses atomically — it
    frees nothing unless EVERY region is synchronized. A lock guards the
    region table."""

    def __init__(self, comm, name: str = "") -> None:
        self.comm = comm
        self.name = name or f"dynwin{id(self):x}"
        self._regions: Dict[int, Window] = {}
        self._next_region = 0
        self._flavor = FLAVOR_DYNAMIC
        self._freed = False
        self._open: Optional[str] = None  # None | "fence" | "lock"
        self._lock = threading.RLock()

    # -- attach / detach ---------------------------------------------------
    def attach(self, shape: Tuple[int, ...], dtype=torch.float32) -> int:
        """MPI_Win_attach: expose a fresh zeroed per-rank region;
        returns its region id. Legal mid-epoch — the new region joins
        the open epoch."""
        with self._lock:
            if self._freed:
                raise MPIError(ErrorCode.ERR_WIN, f"{self.name} freed")
            rid = self._next_region
            self._next_region += 1
            win = win_allocate(self.comm, shape, dtype,
                               f"{self.name}.r{rid}")
            win._flavor = FLAVOR_DYNAMIC
            if self._open == "fence":
                win.fence(_barrier=False)
            elif self._open == "lock":
                win.lock_all()
            self._regions[rid] = win
            return rid

    def detach(self, region: int) -> None:
        """MPI_Win_detach: the region must have no unsynchronized RMA
        queued (same rule as freeing mid-epoch)."""
        with self._lock:
            win = self._region(region)
            if win._pending:
                raise MPIError(
                    ErrorCode.ERR_RMA_SYNC,
                    f"{self.name}: detach of region {region} with "
                    "unsynchronized RMA operations",
                )
            win._freed = True
            win._access_plans.clear()
            del self._regions[region]

    def _region(self, region: int) -> Window:
        with self._lock:
            if self._freed:
                raise MPIError(ErrorCode.ERR_WIN, f"{self.name} freed")
            w = self._regions.get(region)
            if w is None:
                raise MPIError(
                    ErrorCode.ERR_BASE,
                    f"{self.name}: region {region} is not attached "
                    f"(attached: {sorted(self._regions)})",
                )
            return w

    # -- queries -----------------------------------------------------------
    def get_attr(self, key: str):
        if key == WIN_CREATE_FLAVOR:
            return True, self._flavor
        if key == WIN_MODEL:
            return True, MODEL_UNIFIED
        if key == WIN_BASE:
            # MPI_BOTTOM for dynamic windows: no single base
            return True, None
        if key == WIN_SIZE:
            return True, 0
        if key == WIN_DISP_UNIT:
            return True, 1
        return False, None

    def read(self, region: int) -> torch.Tensor:
        return self._region(region).read()

    # -- epochs fan out to every attached region ---------------------------
    def fence(self) -> None:
        with self._lock:
            for w in self._regions.values():
                w.fence(_barrier=False)
            self._open = "fence"
        self.comm.barrier()  # ONE barrier per fence, not per region

    def fence_end(self) -> None:
        with self._lock:
            for w in self._regions.values():
                w.fence_end(_barrier=False)
            self._open = None
        self.comm.barrier()

    def lock_all(self) -> None:
        with self._lock:
            for w in self._regions.values():
                w.lock_all()
            self._open = "lock"

    def unlock_all(self) -> None:
        with self._lock:
            for w in self._regions.values():
                w.unlock_all()
            self._open = None

    def flush_all(self) -> None:
        with self._lock:
            for w in self._regions.values():
                w.flush_all()

    # -- RMA: target = (rank, region) --------------------------------------
    def put(self, data, target: int, *, region: int, **kw):
        return self._region(region).put(data, target, **kw)

    def get(self, target: int, *, region: int, **kw):
        return self._region(region).get(target, **kw)

    def accumulate(self, data, target: int, *, region: int, **kw):
        return self._region(region).accumulate(data, target, **kw)

    def get_accumulate(self, data, target: int, *, region: int, **kw):
        return self._region(region).get_accumulate(data, target, **kw)

    def fetch_and_op(self, data, target: int, *, region: int, **kw):
        return self._region(region).fetch_and_op(data, target, **kw)

    def compare_and_swap(self, value, compare, target: int, *,
                         region: int, **kw):
        return self._region(region).compare_and_swap(
            value, compare, target, **kw)

    def free(self) -> None:
        """Atomic: refuses (freeing NOTHING) unless every region is
        synchronized — a partial free would strand pending ops on a
        half-dead window."""
        with self._lock:
            bad = [rid for rid, w in self._regions.items() if w._pending]
            if bad:
                raise MPIError(
                    ErrorCode.ERR_RMA_SYNC,
                    f"{self.name}: free with unsynchronized RMA in "
                    f"region(s) {bad}",
                )
            for w in self._regions.values():
                w.free()
            self._regions.clear()
            self._freed = True


def win_create_dynamic(comm, name: str = "") -> DynamicWindow:
    """MPI_Win_create_dynamic: an empty window; memory attaches later
    (``ompi/mpi/c/win_create_dynamic.c``); on a spanning comm each
    attached region is a wire window."""
    return DynamicWindow(comm, name)
