"""Nonblocking & persistent collectives — the ``coll/libnbc`` analogue.

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

On a communicator that spans processes (a ``tpurun`` world), the hier
collective's wire exchanges block, so the whole round schedule becomes
a :class:`~runtime.progress.ScheduledOp` posted to the progress engine.
Dispatch never touches the wire; execution happens in posting order —
at ``wait()`` on the caller (polling mode) or off the caller on the
progress thread (``progress_thread`` cvar). Each op carries a wire pump
(:func:`_make_pump`) so engine ticks reap the comm's completed transfers
into the router's early-transfer queue while the schedule is still
queued or mid-round. Blocking spanning collectives go through the SAME
machinery — :func:`run_blocking` posts the schedule and waits it — so
there is exactly one round-advancing code path, and every spanning fire
records or replays its frozen wire plan through :mod:`coll.plan`
(:func:`~coll.plan.spanning_wrap`). The schedule body launches CUDA
work (the shadow comm's collective, the folds): the op carries the
comm's device and the stream current where it was posted, and runs with
both current on whichever thread claims it, so the work is ordered
exactly as if the caller had run it.

Persistent requests build their plan once at ``*_init`` (resolved c_coll
entry, op object, bound buffer, memoized signature); ``Request.start()``
re-fires it against the buffer's CURRENT contents (the MPI persistent
buffer-reuse contract).

Bitwise parity is structural: the nonblocking path runs the identical
collective body the blocking path runs.

Not ported yet: the sentinel hooks (``_inline_tpl``) and observability
spans wait for the observability plane (ROADMAP item 16).
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, Dict, Optional, Tuple

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
# the SAME registered timer coll/driver feeds (registration is
# idempotent): here it covers the spanning POSTING prelude — op
# construction, engine enqueue — before the schedule/wire takes over
_orch = pvar.timer(
    "coll_orchestration_seconds",
    "Python orchestration seconds on the collective dispatch path "
    "(decision, planning, validation, posting — before the compiled "
    "program or wire transport takes over)",
)
_persistent_starts = pvar.counter(
    "nbc_persistent_starts",
    "persistent-collective start() fires (plans built once at *_init)",
)


def _comm_key(comm) -> Tuple[str, int]:
    return ("comm", comm.cid)


def _spanning(comm) -> bool:
    """True for a comm whose schedules run over the wire router. A comm
    that claims to span processes in a runtime with no router (not
    launched under tpurun) has no way to reach its peers: refused."""
    if not getattr(comm, "spans_processes", False):
        return False
    if getattr(getattr(comm, "runtime", None), "wire", None) is None:
        raise MPIError(
            ErrorCode.ERR_NOT_AVAILABLE,
            f"{comm.name} spans controller processes but this runtime "
            "has no wire router (launch the job with tpurun)",
        )
    return True


def _make_pump(comm) -> Callable[[], int]:
    """The op's receive-side wire tick: reap completed collective
    transfers on this comm's payload channel into the router's
    early-transfer queue (a no-op once the comm is freed)."""

    def pump() -> int:
        router = getattr(comm.runtime, "wire", None)
        if router is None or getattr(comm, "_freed", False):
            return 0
        return router.coll_pump(comm)

    return pump


def _on_stream(fn: Callable, device) -> Callable:
    """``fn`` run with the stream that is current HERE (the posting
    thread) made current on whichever thread runs it: the schedule's
    CUDA work is then ordered after the caller's earlier work, and the
    caller's later work after it, as if the caller had run it."""
    if getattr(device, "type", None) != "cuda":
        return fn
    import torch

    stream = torch.cuda.current_stream(device)

    def run(*a, **k):
        with torch.cuda.stream(stream):
            return fn(*a, **k)

    return run


def _make_op(comm, name: str, fn: Callable, args: Tuple,
             kw: Optional[Dict]) -> _progress.ScheduledOp:
    return _progress.ScheduledOp(
        _comm_key(comm), name, _on_stream(fn, comm.device), cid=comm.cid,
        args=args, kw=kw or {}, pump=_make_pump(comm), device=comm.device,
    )


def _post(op: _progress.ScheduledOp) -> None:
    """Hand one fully-wired op to the engine. Completion callbacks
    MUST be attached before this call: with the progress thread on,
    the schedule can run to completion the instant it is posted."""
    _ops_posted.add()
    _progress.engine().post(op)


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
    # expose the schedule handle: per-pass consumers (parallel/tree's
    # hidden-time accounting) read its timing
    req._sched_op = op

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
    an event recorded behind it fires. On a spanning comm it is a
    schedule posted in the comm's collective order."""
    comm._check_alive()
    if _spanning(comm):
        return icoll(comm, "barrier", ())
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
    every family (nothing on the dispatch path waits on the device or
    the wire); a seen signature fires its frozen plan through
    coll/plan."""
    t0 = _time.perf_counter()
    comm._check_alive()
    fn = _resolve(comm, name)
    if not _spanning(comm):
        return async_request(
            _plan.dispatch(comm, name, fn, tuple(args), kw), comm.device)
    nested = _nested_inline(comm, fn, (comm,) + tuple(args), kw)
    if nested is not None:
        return nested
    state = _plan.spanning_state_for(comm, name, args, kw)
    run = _plan.spanning_wrap(state, fn)
    op = _make_op(comm, name, run, (comm,) + tuple(args), kw)
    req = _op_request(op)  # callback wired BEFORE the engine sees it
    _post(op)
    _orch.add(_time.perf_counter() - t0)
    return req


def run_blocking(comm, name: str, fn: Callable, args: Tuple,
                 kw: Optional[Dict] = None) -> Any:
    """A blocking spanning collective = fire the NBC schedule + wait —
    the one round-advancing code path. A collective nested inside a
    running schedule on the SAME comm runs inline on the executing
    thread — sequential, so frames on the comm's channel cannot
    interleave and the outer op still owns the queue head. A nested
    call onto a DIFFERENT comm posts through that comm's queue like any
    other (the engine's claim rule is the one arbiter of who runs on a
    channel). ``args`` are the c_coll entry's (the comm first)."""
    t0 = _time.perf_counter()
    eng = _progress.engine()
    cur = eng.executing()
    if cur is not None and cur.key == _comm_key(comm):
        return fn(*args, **(kw or {}))
    user_args = args[1:] if args and args[0] is comm else args
    state = _plan.spanning_state_for(comm, name, user_args, kw)
    run = _plan.spanning_wrap(state, fn)
    op = _make_op(comm, name, run, args, kw)
    _post(op)
    _orch.add(_time.perf_counter() - t0)
    return eng.wait(op)


def submit(comm, name: str, fn: Callable, args: Tuple,
           kw: Optional[Dict] = None) -> Request:
    """Nonblocking run of an arbitrary collective-ordered callable on the
    comm's schedule queue: keeps posting order with every other schedule
    on the comm, runs at wait() (polling mode) or on the progress thread
    with the comm's device current."""
    comm._check_alive()
    _spanning(comm)
    nested = _nested_inline(comm, fn, args, kw)
    if nested is not None:
        return nested
    op = _make_op(comm, name, fn, args, kw)
    req = _op_request(op)  # callback wired BEFORE the engine sees it
    _post(op)
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
    each start. On a spanning comm each start posts a fresh schedule that
    replays the signature's frozen wire plan (the first start records
    it)."""
    comm._check_alive()
    kw = kw or {}
    if _spanning(comm):
        fn = _resolve(comm, name)

        def bound_args() -> Tuple:
            # the buffer as the blocking call passes it, read NOW (the
            # MPI persistent buffer-reuse contract)
            if not args:
                return ()
            return (comm._buf(args[0]),) + tuple(args[1:])

        # the frozen wire plan is built ONCE per (cid, signature) — the
        # blocking call's signature, so a start() replays a plan a
        # blocking fire froze and vice versa: the first fire records
        # the round structure, every later one replays (coll/plan)
        state = _plan.spanning_state_for(comm, name, bound_args(), kw)

        def fire() -> Request:
            t0 = _time.perf_counter()
            run = _plan.spanning_wrap(state, fn)
            op = _make_op(comm, name, run, (comm,) + bound_args(), kw)
            inner = _op_request(op)
            _post(op)
            _orch.add(_time.perf_counter() - t0)
            return inner
    elif name == "barrier":
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
