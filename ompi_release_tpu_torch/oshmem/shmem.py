"""OpenSHMEM — symmetric heap + put/get/AMO + collectives, in-process.

Counterpart of ``ompi_release_tpu/oshmem/shmem.py`` (the reference's
OSHMEM stack: ``memheap`` symmetric heap, ``spml`` put/get, ``atomic``
AMOs, ``scoll`` collectives with the delegate-to-MPI ``scoll/mpi``
component), with one controller playing every PE:

- A symmetric allocation is one window (``osc/window.py``) with a
  leading PE axis on the comm's device: the same handle is valid for
  every PE, which is the whole symmetric-heap contract
  (``oshmem/mca/memheap``). It holds one standing ``lock_all`` epoch:
  SHMEM has no epochs.
- put/get queue onto the window and complete at ``quiet``/
  ``barrier_all``, OpenSHMEM's own completion rule. Fetch AMOs and get
  are blocking (they flush), put/add are posted.
- The bulk path (``shmem_bulk``, default on): posted puts/AMOs between
  ``quiet()``/``fence()`` boundaries are batched per allocation as host
  tuples and drained as ONE window epoch, which the osc access plans
  close as one frozen plan per (allocation, signature) — on the card a
  CUDA-graph replay. Posted ops follow ``shmem_put_nbi`` source-buffer
  rules: the source is read at the drain, and is reusable after
  ``quiet()``. Blocking calls drain first, so per-call ordering is
  unchanged.
- ``wait_until``, ``test`` and ``set_lock`` poll a device value with
  host sleeps; on the card each poll waits for the card.
- scoll delegates to the coll framework over the same communicator
  (what ``scoll/mpi`` does to OMPI): ``sum_to_all`` is
  ``comm.allreduce(x, SUM)``, whose large f32/bf16 local reductions run
  the op framework's CUDA SUM kernel on the card.
- On a communicator spanning controller processes the heap rides the
  wire window (``osc/wire_win.py``): this process stores its own PEs'
  blocks, and puts, gets and AMOs to a PE in another process ship to its
  home. ``sum_to_all`` there is the ``hier`` allreduce, whose folds run
  the SUM kernel at >= 4 MiB.

With obs on, a bulk drain is one ``shmem_bulk_flush`` span (layer
``osc``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from .. import ops as ops_mod
from ..btl.components import payload_nbytes
from ..mca import pvar
from ..mca import var as mca_var
from ..osc.window import Window, win_allocate
from ..utils.arrays import to_numpy, torch_dtype
from ..utils.errors import ErrorCode, MPIError


def register_vars() -> None:
    mca_var.register(
        "shmem_bulk", "bool", True,
        "Batch posted SHMEM puts/AMOs per symmetric allocation between "
        "quiet()/fence() boundaries and drain them as one planned window "
        "epoch (one frozen access plan per (allocation, signature) via "
        "osc/plan); false restores per-call window queueing",
    )


register_vars()

_heap_bytes = pvar.highwatermark(
    "shmem_heap_bytes", "symmetric heap bytes allocated"
)
_bulk_ops = pvar.counter(
    "shmem_bulk_ops",
    "posted SHMEM ops deferred into the per-allocation bulk queue",
)
_bulk_flushes = pvar.counter(
    "shmem_bulk_flushes",
    "bulk-queue drains (one planned window epoch per allocation)",
)

#: generation-cached shmem_bulk snapshot — the posted-op hot path reads
#: one attribute + int compare, never the registry
_conf: Tuple[int, bool] = (-1, True)


def _bulk_on() -> bool:
    global _conf
    gen = mca_var.VARS.generation
    if _conf[0] != gen:
        _conf = (gen, bool(mca_var.get("shmem_bulk", True)))
    return _conf[1]


def _first(t: torch.Tensor) -> int:
    """The first element of a fetched value as a Python int (waits for
    the card)."""
    return int(t.reshape(-1)[0])



class SymmetricArray:
    """One symmetric allocation: ``shape`` per PE, PE i's block in row
    i. The handle itself is the symmetric address."""

    def __init__(self, ctx: "ShmemCtx", win: Window) -> None:
        self._ctx = ctx
        self._win = win
        win.lock_all()  # SHMEM has no epochs: one standing passive epoch

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._win.shape

    @property
    def dtype(self) -> torch.dtype:
        return self._win.dtype

    def local(self, pe: int) -> torch.Tensor:
        """PE ``pe``'s local block (the shmem_ptr analogue): a snapshot,
        unchanged by later puts. One controller sees every PE; on a
        communicator spanning processes only this process's PEs are
        addressable — the reference's shmem_ptr returns NULL for a PE
        without a load/store path (``oshmem/shmem/c/shmem_ptr.c``), so a
        PE in another process raises ``ERR_RMA_SHARED``: use
        :meth:`ShmemCtx.get` for it."""
        self._ctx._drain(self)
        self._win.flush_all()
        comm = self._win.comm
        if getattr(comm, "spans_processes", False) \
                and pe not in comm.local_comm_ranks:
            raise MPIError(
                ErrorCode.ERR_RMA_SHARED,
                f"shmem_ptr: PE {pe} lives in another controller process "
                "(no load/store path); use get()",
            )
        return self._win._read_row(pe)

    def free(self) -> None:
        self._ctx._drain(self)  # posted ops must land, not vanish
        self._win.unlock_all()
        self._win.free()
        self._ctx._allocs.discard(self)


class ShmemCtx:
    """The OpenSHMEM world (``shmem_init`` state)."""

    def __init__(self, comm) -> None:
        self.comm = comm
        self._allocs: set = set()
        # the bulk path: per-allocation queues of light (kind, pe, data,
        # op, index) tuples — payload copies and window queueing wait
        # for the drain, where the whole batch closes as ONE window epoch
        self._bulk: Dict["SymmetricArray", List[Tuple]] = {}

    # -- setup / query (shmem.h accessors) ---------------------------------
    @property
    def n_pes(self) -> int:
        return self.comm.size

    def malloc(self, shape: Tuple[int, ...], dtype=torch.float32
               ) -> SymmetricArray:
        """shmem_malloc: symmetric allocation (memheap analogue)."""
        dtype = torch_dtype(dtype)
        arr = SymmetricArray(self, win_allocate(self.comm, tuple(shape),
                                                dtype))
        self._allocs.add(arr)
        _heap_bytes.add(int(np.prod(shape)) * dtype.itemsize * self.n_pes)
        return arr

    # -- the bulk path (shmem_bulk) ----------------------------------------
    def _post(self, sym: SymmetricArray, kind: str, pe: int, data,
              op, index) -> None:
        """Defer one posted op into ``sym``'s bulk queue (nbi semantics:
        the source lands at the next drain). The tuple carries the
        frozen Op OBJECT, so osc/plan keys the plan by the object, never
        by an op name."""
        self._bulk.setdefault(sym, []).append((kind, pe, data, op, index))
        _bulk_ops.add()

    def _drain(self, sym: SymmetricArray) -> None:
        """Replay ``sym``'s bulk queue as one window epoch and flush:
        the whole batch closes as one frozen plan per (allocation,
        signature)."""
        q = self._bulk.pop(sym, None)
        if not q:
            return
        rec = _obs.enabled
        t0 = time.perf_counter() if rec else 0.0
        win = sym._win
        for kind, pe, data, op, index in q:
            if kind == "put":
                win.put(data, pe, index=index)
            else:  # acc
                win.accumulate(data, pe, op=op, index=index)
        win.flush_all()
        _bulk_flushes.add()
        if rec and _obs.enabled:
            _obs.record(
                "shmem_bulk_flush", "osc", t0,
                time.perf_counter() - t0,
                nbytes=sum(payload_nbytes(d) for _, _, d, _, _ in q),
                comm_id=win.comm.cid)

    # -- data movement (spml put/get) --------------------------------------
    def put(self, sym: SymmetricArray, data, pe: int) -> None:
        """shmem_put: posted; completes at quiet/barrier_all."""
        if _bulk_on():
            self._post(sym, "put", pe, data, None, None)
            return
        sym._win.put(data, pe)

    def get(self, sym: SymmetricArray, pe: int) -> torch.Tensor:
        """shmem_get: blocking (flushes pending ops first)."""
        self._drain(sym)
        sym._win.flush_all()
        req = sym._win.get(pe)
        sym._win.flush_all()
        return req.value

    def put_elem(self, sym: SymmetricArray, value, index, pe: int) -> None:
        """Scalar put at a flat index (shmem_p): a true single-element
        posted put — O(1) staged bytes, no read-modify-write of the
        whole slot."""
        if _bulk_on():
            self._post(sym, "put", pe, value, None, int(index))
            return
        sym._win.put(value, pe, index=int(index))

    # -- atomics (oshmem/mca/atomic) ---------------------------------------
    def atomic_add(self, sym: SymmetricArray, value, pe: int) -> None:
        if _bulk_on():
            self._post(sym, "acc", pe, value, ops_mod.SUM, None)
            return
        sym._win.accumulate(value, pe, op=ops_mod.SUM)

    def atomic_fetch_add(self, sym: SymmetricArray, value, pe: int
                         ) -> torch.Tensor:
        self._drain(sym)  # fetch observes earlier posted ops
        req = sym._win.fetch_and_op(value, pe, op=ops_mod.SUM)
        sym._win.flush(pe)
        return req.value

    def atomic_swap(self, sym: SymmetricArray, value, pe: int
                    ) -> torch.Tensor:
        self._drain(sym)
        req = sym._win.fetch_and_op(value, pe, op=ops_mod.REPLACE)
        sym._win.flush(pe)
        return req.value

    def atomic_compare_swap(self, sym: SymmetricArray, cond, value, pe: int
                            ) -> torch.Tensor:
        self._drain(sym)
        req = sym._win.compare_and_swap(value, cond, pe)
        sym._win.flush(pe)
        return req.value

    def atomic_inc(self, sym: SymmetricArray, pe: int) -> None:
        """shmem_inc: add 1 (the counter idiom)."""
        self.atomic_add(sym, torch.ones(sym.shape, dtype=sym.dtype), pe)

    def atomic_fetch_inc(self, sym: SymmetricArray, pe: int
                         ) -> torch.Tensor:
        return self.atomic_fetch_add(
            sym, torch.ones(sym.shape, dtype=sym.dtype), pe
        )

    def atomic_set(self, sym: SymmetricArray, value, pe: int) -> None:
        """shmem_atomic_set: unconditional replace (no fetch)."""
        if _bulk_on():
            self._post(sym, "acc", pe, value, ops_mod.REPLACE, None)
            return
        sym._win.accumulate(value, pe, op=ops_mod.REPLACE)

    def atomic_fetch(self, sym: SymmetricArray, pe: int) -> torch.Tensor:
        """shmem_atomic_fetch: an atomic read = fetch_add(0)."""
        return self.atomic_fetch_add(
            sym, torch.zeros(sym.shape, dtype=sym.dtype), pe
        )

    # -- point-to-point synchronization (shmem_wait_until) -----------------
    def wait_until(self, sym: SymmetricArray, cmp: str, value, *,
                   pe: int, timeout_s: float = 30.0,
                   poll_s: float = 0.001) -> torch.Tensor:
        """Block until pe's symmetric variable satisfies the comparison
        — the SHMEM p2p synchronization primitive (``shmem_wait_until``;
        cmp in eq/ne/gt/ge/lt/le). ``pe`` is explicit because one
        controller plays every PE. Progress comes from other PEs' posted
        puts/AMOs being flushed (the poll flushes so posted ops land);
        each poll reads the value to the host."""
        cmps = {
            "eq": np.equal, "ne": np.not_equal,
            "gt": np.greater, "ge": np.greater_equal,
            "lt": np.less, "le": np.less_equal,
        }
        if cmp not in cmps:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"wait_until cmp must be one of {list(cmps)}")
        deadline = time.monotonic() + timeout_s
        while True:
            got = self.get(sym, pe)
            cur = to_numpy(got)
            if bool(np.all(cmps[cmp](cur, value))):
                return got
            if time.monotonic() > deadline:
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"wait_until({cmp}, {value}) timed out; last "
                    f"value {cur!r}",
                )
            time.sleep(poll_s)

    def test(self, sym: SymmetricArray, cmp: str, value, *,
             pe: int) -> bool:
        """Nonblocking wait_until (shmem_test)."""
        try:
            self.wait_until(sym, cmp, value, pe=pe, timeout_s=0.0)
            return True
        except MPIError as e:
            if e.code is ErrorCode.ERR_PENDING:  # just not yet
                return False
            raise  # real failures (freed window, bad pe) must surface

    # -- ordering (shmem_quiet / shmem_fence) ------------------------------
    def quiet(self) -> None:
        """Complete all outstanding puts/AMOs (shmem_quiet): drain every
        allocation's bulk queue (one planned epoch each) and flush
        anything queued outside the bulk path."""
        for a in list(self._allocs):
            self._drain(a)
            a._win.flush_all()

    def fence(self) -> None:
        """Ordering only; ops apply in submission order, so fence ==
        quiet here (stronger is allowed)."""
        self.quiet()

    def barrier_all(self) -> None:
        self.quiet()
        self.comm.barrier()

    # -- collectives (scoll -> coll framework, the scoll/mpi path) ---------
    def broadcast(self, x, root: int = 0):
        return self.comm.bcast(x, root=root)

    def fcollect(self, x):
        """shmem_fcollect: concatenation of every PE's block."""
        return self.comm.allgather(x)

    def alltoall(self, x):
        return self.comm.alltoall(x)

    def collect(self, bufs):
        """shmem_collect: ragged per-PE blocks concatenated in PE order
        (fcollect's equal-size constraint lifted) — rides allgatherv."""
        return self.comm.allgatherv(bufs)

    def sum_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.SUM)

    def prod_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.PROD)

    def max_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.MAX)

    def min_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.MIN)

    def and_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.BAND)

    def or_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.BOR)

    def xor_to_all(self, x):
        return self.comm.allreduce(x, ops_mod.BXOR)

    # -- distributed locks (shmem_set_lock/clear_lock/test_lock) -----------
    def lock_create(self) -> SymmetricArray:
        """A SHMEM lock: a symmetric word, 0 = free, pe+1 = held by pe
        (``shmem.h.in:167`` lock surface; the reference's
        ``oshmem/mca/atomic`` backs its locks with the same AMOs). The
        lock word lives on its home PE (0): contenders CAS the home
        copy."""
        return self.malloc((1,), torch.int32)

    def set_lock(self, lock: SymmetricArray, *, pe: int,
                 timeout_s: float = 30.0) -> None:
        """Acquire: spin CAS(0 -> pe+1) on the home PE with backoff.
        Re-acquiring a held lock raises instead of hanging."""
        me = int(pe) + 1
        deadline = time.monotonic() + timeout_s
        delay = 0.0005
        while True:
            old = _first(self.atomic_compare_swap(lock, 0, me, pe=0))
            if old == 0:
                return
            if old == me:
                raise MPIError(
                    ErrorCode.ERR_OTHER,
                    f"PE {pe} already holds this lock (shmem locks are "
                    "not recursive)",
                )
            if time.monotonic() > deadline:
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    f"set_lock: PE {old - 1} held the lock for "
                    f">{timeout_s}s",
                )
            time.sleep(delay)
            delay = min(delay * 2, 0.01)

    def test_lock(self, lock: SymmetricArray, *, pe: int) -> bool:
        """One CAS attempt; True = acquired (shmem_test_lock's 0)."""
        return _first(self.atomic_compare_swap(lock, 0, int(pe) + 1,
                                               pe=0)) == 0

    def clear_lock(self, lock: SymmetricArray, *, pe: int) -> None:
        """Release; only the holder may clear (erroneous otherwise in
        OpenSHMEM — detected here rather than corrupting the word)."""
        me = int(pe) + 1
        old = _first(self.atomic_compare_swap(lock, me, 0, pe=0))
        if old != me:
            raise MPIError(
                ErrorCode.ERR_OTHER,
                f"clear_lock by PE {pe} but the lock is "
                + ("free" if old == 0 else f"held by PE {old - 1}"),
            )

    def finalize(self) -> None:
        for a in list(self._allocs):
            a.free()


_ctx: Optional[ShmemCtx] = None


def shmem_init(comm=None) -> ShmemCtx:
    """shmem_init: reuses the runtime (OSHMEM sits beside OMPI on the
    same runtime). Without ``comm`` it brings the runtime up on its
    default device."""
    global _ctx
    if _ctx is not None:
        return _ctx
    if comm is None:
        from ..runtime import runtime as rt_mod

        comm = rt_mod.init()
    _ctx = ShmemCtx(comm)
    return _ctx


def shmem_finalize() -> None:
    global _ctx
    if _ctx is not None:
        _ctx.finalize()
        _ctx = None
