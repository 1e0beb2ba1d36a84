"""Nonblocking & persistent collectives — the ``coll/libnbc`` analogue,
in-process half.

Counterpart of ``ompi_release_tpu/coll/nbc.py``. The reference runs
``MPI_Iallreduce``-class operations as round schedules advanced by the
progress engine (``ompi/mca/coll/libnbc/nbc.c``) and MPI-4 persistent
collectives (``MPI_Allreduce_init``) as a schedule built ONCE and fired
by ``MPI_Start`` many times. On a communicator inside one process:

- CUDA's stream order IS the progress engine: dispatch enqueues the
  collective's kernels on the current stream and returns;
  :func:`async_request` records a ``torch.cuda.Event`` behind them and
  wraps it in a Request whose readiness is ``event.query()`` and whose
  wait is ``event.synchronize()``. The request joins the progress
  engine's poll list, so a tick (or the progress thread) completes it
  off the caller. Nothing on the dispatch path synchronises with the
  device. On the CPU the work is done at dispatch and the request is
  already complete.
- every i-family call and every persistent ``start()`` goes through
  :func:`coll.plan.dispatch`, as the blocking path does: a seen
  signature fires its frozen plan (on the card, a CUDA-graph replay).

Persistent requests build their plan once at ``*_init`` (resolved c_coll
entry, op object, bound buffer, memoized signature); ``Request.start()``
re-fires it against the buffer's CURRENT contents (the MPI persistent
buffer-reuse contract).

Bitwise parity is structural: the nonblocking path runs the identical
collective body the blocking path runs.

Not ported yet: the spanning (multi-process) branches raise
``ERR_NOT_AVAILABLE`` until the multi-process slice; the sentinel and
observability hooks wait for ``obs``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..mca import pvar
from ..request.request import Request
from ..runtime import progress as _progress
from ..utils.errors import ErrorCode, MPIError
from . import plan as _plan

_ops_posted = pvar.counter(
    "nbc_ops_posted",
    "nonblocking/blocking collective schedules posted to the progress "
    "engine",
)
_persistent_starts = pvar.counter(
    "nbc_persistent_starts",
    "persistent-collective start() fires (plans built once at *_init)",
)


def _comm_key(comm) -> Tuple[str, int]:
    return ("comm", comm.cid)


def _in_process(comm) -> None:
    if getattr(comm, "spans_processes", False):
        raise MPIError(
            ErrorCode.ERR_NOT_AVAILABLE,
            f"{comm.name} spans controller processes: nonblocking "
            "collectives there need the multi-process runtime, which is "
            "not ported yet",
        )


def _resolve(comm, name: str) -> Callable:
    fn = comm.c_coll.get(name)
    if fn is None:
        raise MPIError(
            ErrorCode.ERR_INTERN,
            f"no {name} implementation installed on {comm.name}",
        )
    return fn


def _op_request(op: _progress.ScheduledOp) -> Request:
    """Bind one NOT-YET-POSTED schedule to a Request (the callback is
    attached before the engine can run the op): test() advances the
    engine one bounded step toward the op and surfaces its error, wait()
    drives the engine's posting-order drain, completion carries the
    schedule's result."""
    eng = _progress.engine()

    def prog(_r, _op=op, _eng=eng) -> None:
        _eng.advance_toward(_op)
        if _op.done.is_set() and _op.error is not None:
            raise _op.error

    def block(_op=op, _eng=eng) -> None:
        _eng.wait(_op)  # raises the schedule's error

    req = Request(progress_fn=prog, block_fn=block)

    def finish(o, _req=req) -> None:
        if o.error is None:
            _req.complete(value=o.result)

    op.callbacks.append(finish)
    return req


# ---------------------------------------------------------------------------
# in-process: the stream's order wrapped as a Request
# ---------------------------------------------------------------------------

def async_request(value, device) -> Request:
    """A Request for work already enqueued on ``device``'s current
    stream, carrying ``value``: complete once an event recorded behind
    that work fires (checked by test() and by every engine tick); on the
    CPU, complete now."""
    if getattr(device, "type", None) != "cuda":
        req = Request()
        req.complete(value=value)
        return req
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    req = Request(ready_fn=ev.query, block_fn=ev.synchronize)
    req.value = value
    _progress.engine().add_poll(req)
    return req


def ibarrier(comm) -> Request:
    """A barrier that really is nonblocking: in driver mode every rank's
    work is queued on the comm's device, so the barrier completes when
    an event recorded behind it fires."""
    comm._check_alive()
    _in_process(comm)
    return async_request(None, comm.device)


# ---------------------------------------------------------------------------
# public entry points (Communicator delegates here)
# ---------------------------------------------------------------------------

def _nested_inline(comm, fn, args, kw) -> Optional[Request]:
    """A schedule submitted from INSIDE a running schedule on the same
    comm cannot queue (the outer op owns the queue head until it
    completes): run it inline and return an already-complete Request
    (MPI lets a nonblocking op complete at initiation). None when not
    nested."""
    cur = _progress.engine().executing()
    if cur is None or cur.key != _comm_key(comm):
        return None
    req = Request()
    req.complete(value=fn(*args, **(kw or {})))
    return req


def icoll(comm, name: str, args: Tuple, kw: Optional[Dict] = None
          ) -> Request:
    """Nonblocking collective: dispatch returns before completion for
    every family (nothing on the dispatch path waits on the device); a
    seen signature fires its frozen plan through coll/plan."""
    comm._check_alive()
    _in_process(comm)
    fn = _resolve(comm, name)
    return async_request(_plan.dispatch(comm, name, fn, tuple(args), kw),
                         comm.device)


def submit(comm, name: str, fn: Callable, args: Tuple,
           kw: Optional[Dict] = None) -> Request:
    """Nonblocking run of an arbitrary collective-ordered callable on the
    comm's schedule queue: keeps posting order with every other schedule
    on the comm, runs at wait() (polling mode) or on the progress thread
    with the comm's device current."""
    comm._check_alive()
    _in_process(comm)
    nested = _nested_inline(comm, fn, args, kw)
    if nested is not None:
        return nested
    op = _progress.ScheduledOp(_comm_key(comm), name, fn, cid=comm.cid,
                               args=args, kw=kw or {}, device=comm.device)
    req = _op_request(op)  # callback wired BEFORE the engine sees it
    _ops_posted.add()
    _progress.engine().post(op)
    return req


def drain_comm(comm) -> None:
    """Complete every outstanding schedule on ``comm`` in posting order
    (comm free path)."""
    _progress.engine().drain_key(_comm_key(comm))


# ---------------------------------------------------------------------------
# persistent collectives (MPI_Allreduce_init / MPI_Start)
# ---------------------------------------------------------------------------

def persistent(comm, name: str, args: Tuple, kw: Optional[Dict] = None
               ) -> Request:
    """Build the plan ONCE, fire it per start(): the c_coll entry and the
    argument binding resolve now; each ``Request.start()`` re-fires the
    plan against the bound buffer's CURRENT contents without blocking.
    A buffer already on the comm's device is read in place by its frozen
    plan (no copy per start); any other buffer is copied to the device at
    each start."""
    comm._check_alive()
    _in_process(comm)
    kw = kw or {}
    if name == "barrier":
        def fire() -> Request:
            return comm.ibarrier()
    else:
        fn = _resolve(comm, name)
        bound = comm._buf(args[0]) is args[0]
        sig_box: list = []  # signature computed once, not per start

        def fire() -> Request:
            a = (comm._buf(args[0]),) + tuple(args[1:])
            return async_request(
                _plan.dispatch(comm, name, fn, a, kw, sig_box=sig_box,
                               bound=bound),
                comm.device)

    def start(req) -> None:
        _persistent_starts.add()
        req._inner = fire()

    def prog(r) -> None:
        inner = getattr(r, "_inner", None)
        if inner is None:
            return
        done, _st = inner.test()
        if done and not r.is_complete:
            r.complete(value=inner.value, status=inner.status)

    req = Request(progress_fn=prog, persistent_start=start)

    def block() -> None:
        inner = req._inner
        st = inner.wait()
        req.complete(value=inner.value, status=st)

    req._block_fn = block
    req._inner = None
    return req
