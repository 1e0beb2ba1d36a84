"""Small-message fusion: a Horovod-fusion-buffer / BTL-send-coalescing
analogue for driver-mode collectives (counterpart of
``ompi_release_tpu/coll/fusion.py``).

Concurrent small allreduces on the same ``(comm, op, dtype)`` pack into
ONE flat buffer and issue as ONE collective, amortizing the
per-collective dispatch cost.

Contract
--------
- Tensors whose per-rank payload is below ``coll_fusion_threshold``
  queue in the communicator's :class:`FusionBuffer`
  (``comm.fusion_buffer()``); larger ones dispatch immediately.
- A queue drains on: :meth:`FusionBuffer.flush`, a handle's
  :meth:`FusedHandle.result` (correctness never waits on policy),
  pending bytes exceeding ``coll_fusion_buffer_bytes``, or the oldest
  pending tensor aging past ``coll_fusion_max_delay_us`` (checked at
  every submission).
- Packing uses :func:`plan_buckets`, the greedy same-dtype planner.
  The JAX package concatenates on the host; here each bucket is one
  ``torch.cat`` along dim 1 on the comm's device, and the reduced
  result is sliced back per tensor.

pvars: ``coll_fusion_batched`` (tensors coalesced),
``coll_fusion_flushes`` (fused collectives issued),
``coll_fusion_bytes_saved`` (payload bytes that rode an issued
collective instead of their own).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..utils.errors import ErrorCode, MPIError

_batched = pvar.counter(
    "coll_fusion_batched", "tensors coalesced into fused collectives"
)
_flushes = pvar.counter(
    "coll_fusion_flushes", "fused device collectives issued"
)
_bytes_saved = pvar.counter(
    "coll_fusion_bytes_saved",
    "payload bytes that rode a fused collective instead of issuing "
    "their own (bytes beyond the first tensor of each flush)",
)


def register_vars() -> None:
    mca_var.register(
        "coll_fusion_threshold", "size", 64 * 1024,
        "Per-rank bytes below which a collective is eligible for "
        "fusion (Horovod fusion-buffer / BTL coalescing analogue); "
        "0 disables fusion (everything dispatches immediately)",
    )
    mca_var.register(
        "coll_fusion_buffer_bytes", "size", 4 * 1024 * 1024,
        "Pending-bytes capacity of the fusion buffer: a submission "
        "pushing past this flushes the queue",
    )
    mca_var.register(
        "coll_fusion_max_delay_us", "int", 2000,
        "Oldest pending tensor's max age in microseconds: a "
        "submission finding older pendings flushes them first "
        "(the fusion latency bound)",
    )


register_vars()  # idempotent; cvars must exist before first buffer


def plan_buckets(items: Iterable[Tuple[Any, int, Any]],
                 capacity: int) -> List[List[Any]]:
    """Greedy in-order fusion planning.

    ``items`` yields ``(tag, nbytes, group_key)``; a bucket closes when
    adding the next item would exceed ``capacity`` or its ``group_key``
    (dtype) differs from the bucket's. Returns the buckets as lists of
    tags, order preserved. An item alone larger than ``capacity`` still
    gets a bucket (it must go somewhere)."""
    buckets: List[List[Any]] = []
    cur: List[Any] = []
    cur_bytes = 0
    cur_key = None
    for tag, nbytes, key in items:
        if cur and (cur_bytes + nbytes > capacity or key != cur_key):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(tag)
        cur_bytes += nbytes
        cur_key = key
    if cur:
        buckets.append(cur)
    return buckets


class FusedHandle:
    """Future for one tensor submitted to a :class:`FusionBuffer`.
    ``result()`` returns the reduced tensor, flushing the buffer first
    if this tensor is still pending."""

    __slots__ = ("_buffer", "_value", "_error", "_event")

    def __init__(self, buffer: Optional["FusionBuffer"],
                 value: Any = None, done: bool = False) -> None:
        self._buffer = buffer
        self._value = value
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        if done:
            self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def result(self) -> Any:
        if not self._event.is_set():
            # a concurrent flush may already have claimed this tensor's
            # queue (flush swaps queues under the lock and completes
            # handles outside it): the EVENT is the completion signal
            self._buffer.flush()
            self._event.wait()
        if self._error is not None:
            raise self._error
        return self._value


class _Pending:
    __slots__ = ("handle", "x", "shape", "nbytes", "t_submit")

    def __init__(self, handle: FusedHandle, x, shape, nbytes: int) -> None:
        self.handle = handle
        self.x = x
        self.shape = shape
        self.nbytes = nbytes
        self.t_submit = time.perf_counter()


class FusionBuffer:
    """Per-communicator fusion buffer for driver-mode collectives.

    Thread-safe: submissions and flushes serialize on one lock; the
    collectives themselves run outside it."""

    def __init__(self, comm, *, threshold: Optional[int] = None,
                 capacity: Optional[int] = None,
                 max_delay_us: Optional[int] = None) -> None:
        self.comm = comm
        self._threshold = threshold
        self._capacity = capacity
        self._max_delay_us = max_delay_us
        self._lock = threading.Lock()
        # (op, dtype) -> [_Pending]; keyed by the op OBJECT so two
        # same-named ops with different combiners never share a queue
        self._queues: Dict[Tuple[Any, Any], List[_Pending]] = {}
        self._pending_bytes = 0  # running total (O(1) capacity check)

    # -- config (cvars re-read per call so runtime tuning applies) ---------
    def threshold(self) -> int:
        if self._threshold is not None:
            return self._threshold
        return int(mca_var.get("coll_fusion_threshold", 64 * 1024))

    def capacity(self) -> int:
        if self._capacity is not None:
            return self._capacity
        return int(mca_var.get("coll_fusion_buffer_bytes", 4 * 1024 * 1024))

    def max_delay_s(self) -> float:
        us = (self._max_delay_us if self._max_delay_us is not None
              else int(mca_var.get("coll_fusion_max_delay_us", 2000)))
        return us / 1e6

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # -- submission --------------------------------------------------------
    def allreduce(self, x, op=None) -> FusedHandle:
        """Submit a driver-mode allreduce (leading axis = comm.size).
        Below the fusion threshold the tensor queues for coalescing;
        at/above it (or for pair ops, which have no flat packing) it
        dispatches immediately."""
        from .. import ops as ops_mod

        op = op or ops_mod.SUM
        if op.is_pair_op or isinstance(x, tuple):
            return FusedHandle(None, self.comm.allreduce(x, op), True)
        arr = self.comm._buf(x)
        if arr.dim() < 1 or arr.shape[0] != self.comm.size:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"fused allreduce needs a driver-mode buffer with "
                f"leading axis == comm size {self.comm.size}, got "
                f"shape {tuple(arr.shape)}",
            )
        per_rank = int(arr[0].numel()) * arr.element_size()
        thresh = self.threshold()
        if thresh <= 0 or per_rank >= thresh:
            return FusedHandle(None, self.comm.allreduce(arr, op), True)

        handle = FusedHandle(self)
        now = time.perf_counter()
        max_delay = self.max_delay_s()
        with self._lock:
            expired = any(
                now - q[0].t_submit > max_delay
                for q in self._queues.values() if q
            )
        if expired:
            # the latency bound: older pendings flush BEFORE the new
            # tensor queues
            self.flush()
        key = (op, arr.dtype)
        with self._lock:
            self._queues.setdefault(key, []).append(
                _Pending(handle, arr.reshape(self.comm.size, -1),
                         arr.shape, per_rank)
            )
            self._pending_bytes += per_rank
            over = self._pending_bytes > self.capacity()
        if over:
            self.flush()
        return handle

    # -- drain -------------------------------------------------------------
    def flush(self) -> int:
        """Issue every pending queue as fused collectives; returns how
        many collectives were issued."""
        with self._lock:
            queues = self._queues
            self._queues = {}
            self._pending_bytes = 0
        t0 = time.perf_counter()
        issued = 0
        fused_bytes = 0
        claimed = [p for q in queues.values() for p in q]
        try:
            for key, pendings in queues.items():
                if not pendings:
                    continue
                op = key[0]
                # plan_buckets gives an oversize item its own bucket
                buckets = plan_buckets(
                    ((p, p.nbytes, key) for p in pendings),
                    self.capacity(),
                )
                for bucket in buckets:
                    issued += 1
                    _flushes.add()
                    _batched.add(len(bucket))
                    _bytes_saved.add(sum(p.nbytes for p in bucket[1:]))
                    fused_bytes += sum(p.nbytes for p in bucket)
                    if len(bucket) == 1:
                        p = bucket[0]
                        p.handle._complete(
                            self.comm.allreduce(p.x.reshape(p.shape), op)
                        )
                        continue
                    flat = torch.cat([p.x for p in bucket], dim=1)
                    red = self.comm.allreduce(flat, op)
                    off = 0
                    for p in bucket:
                        width = p.x.shape[1]
                        p.handle._complete(
                            red[:, off:off + width].reshape(p.shape)
                        )
                        off += width
        except BaseException as e:
            # the queues were already claimed: handles that will never
            # complete must fail loudly, not leave result() blocked
            for p in claimed:
                if not p.handle.done:
                    p.handle._fail(e)
            raise
        if issued and _obs.enabled:
            _obs.record("fusion_flush", "fusion", t0,
                        time.perf_counter() - t0, nbytes=fused_bytes,
                        comm_id=getattr(self.comm, "cid", -1))
        return issued
