"""Completion objects — the ``ompi/request`` analogue.

Counterpart of ``ompi_release_tpu/request/request.py``. The reference
completes requests by spinning the progress engine
(``ompi/request/request.h:370-386`` wait_completion →
``opal_progress()``). Host-side work (matching, deferred rendezvous
copies) progresses through callbacks the owning engine registers on the
request; device work is waited on through ``block_fn`` (for CUDA work
the owner synchronises its stream or event there).

Generalized requests (``ompi/request/grequest.c``) carry user
query/free/cancel callbacks and are completed by user code.

With obs on, ``wait()`` journals how long completion blocked the host
(a ``wait`` span, layer ``request``).
"""

from __future__ import annotations

import enum
import threading
import time as _time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from .. import obs as _obs
from ..mca import pvar
from ..utils.errors import ErrorCode, MPIError

_req_count = pvar.counter("requests_created", "requests ever created")

#: shared progress hooks: ONE call advances every pending request an
#: engine owns, so the multi-request operations below tick once per pass
#: instead of spinning per request, and a bare wait() drives the engine
#: instead of sleeping blind.
_progress_hooks: List[Callable[[], int]] = []


def register_progress_hook(fn: Callable[[], int]) -> None:
    """Register an engine tick (idempotent by identity). The hook must
    be nonblocking and return how many items progressed."""
    if fn not in _progress_hooks:
        _progress_hooks.append(fn)


def run_progress() -> int:
    """Run every registered engine tick once; returns total items
    progressed. THE shared hook wait_all/test_all/wait_any and
    from_future-backed waits call between completion checks."""
    n = 0
    for fn in list(_progress_hooks):
        n += int(fn() or 0)
    return n


class RequestState(enum.Enum):
    INACTIVE = "inactive"  # persistent request not started
    ACTIVE = "active"
    COMPLETE = "complete"
    CANCELLED = "cancelled"


class Status:
    """MPI_Status analogue."""

    __slots__ = ("source", "tag", "error", "count", "cancelled")

    def __init__(self, source: int = -1, tag: int = -1, error: int = 0,
                 count: int = 0, cancelled: bool = False) -> None:
        self.source = source
        self.tag = tag
        self.error = error
        self.count = count
        self.cancelled = cancelled

    def __repr__(self) -> str:
        return (
            f"Status(source={self.source}, tag={self.tag}, "
            f"count={self.count})"
        )


class Request:
    """A completion handle.

    ``progress_fn`` (optional) is polled by test/wait — the hook where
    the owning engine advances host-side state (e.g. a rendezvous
    transfer waiting for its matching recv). ``ready_fn`` (optional)
    reports whether async device work has finished without blocking;
    ``block_fn`` blocks on it.
    """

    def __init__(self, *, progress_fn: Optional[Callable] = None,
                 ready_fn: Optional[Callable] = None,
                 block_fn: Optional[Callable] = None,
                 persistent_start: Optional[Callable] = None) -> None:
        _req_count.add()
        self.state = (
            RequestState.INACTIVE if persistent_start else RequestState.ACTIVE
        )
        self.status = Status()
        self.value: Any = None  # recv payload once complete
        self._progress_fn = progress_fn
        self._ready_fn = ready_fn
        self._block_fn = block_fn
        self._persistent_start = persistent_start
        self._lock = threading.Lock()
        self._on_complete: List[Callable] = []

    # -- engine side -------------------------------------------------------
    def complete(self, value: Any = None, status: Optional[Status] = None
                 ) -> None:
        with self._lock:
            if self.state is RequestState.COMPLETE:
                return
            self.value = value if value is not None else self.value
            if status is not None:
                self.status = status
            self.state = RequestState.COMPLETE
            callbacks = list(self._on_complete)
        for cb in callbacks:
            cb(self)

    def on_complete(self, cb: Callable) -> None:
        run_now = False
        with self._lock:
            if self.state is RequestState.COMPLETE:
                run_now = True
            else:
                self._on_complete.append(cb)
        if run_now:
            cb(self)

    # -- user side ---------------------------------------------------------
    @property
    def is_complete(self) -> bool:
        return self.state is RequestState.COMPLETE

    def start(self) -> "Request":
        """Restart a persistent request (MPI_Start)."""
        if self._persistent_start is None:
            raise MPIError(ErrorCode.ERR_REQUEST,
                           "start() on a non-persistent request")
        if self.state is RequestState.ACTIVE:
            raise MPIError(ErrorCode.ERR_REQUEST,
                           "start() on an active request")
        self.state = RequestState.ACTIVE
        self.status = Status()
        self._persistent_start(self)
        return self

    def poll(self) -> bool:
        """Nonblocking readiness check used by a progress engine's tick:
        completes the request if its async device work finished. Unlike
        test(), never invokes progress_fn (the engine IS the caller)."""
        if self.state is RequestState.COMPLETE:
            return True
        if self.state is not RequestState.ACTIVE:
            return False
        if self._ready_fn is not None and self._ready_fn():
            self.complete()
        return self.state is RequestState.COMPLETE

    def test(self) -> Tuple[bool, Optional[Status]]:
        if self.state is RequestState.INACTIVE:
            return True, None  # MPI: inactive tests as complete/empty
        if self.state is RequestState.COMPLETE:
            return True, self.status
        if self._progress_fn is not None:
            self._progress_fn(self)
        if (self.state is not RequestState.COMPLETE
                and self._ready_fn is not None and self._ready_fn()):
            self.complete()
        return self.is_complete, self.status if self.is_complete else None

    def wait(self) -> Status:
        rec = _obs.enabled  # capture once: flag may flip mid-wait
        t0 = _time.perf_counter() if rec else 0.0
        done, _ = self.test()
        if not done:
            if self._block_fn is not None:
                self._block_fn()
                self.complete()
            else:
                # host-side requests complete via callbacks; spinning
                # means a matching operation was never posted
                raise MPIError(
                    ErrorCode.ERR_PENDING,
                    "wait() would deadlock: request has no device work "
                    "and no completion event (missing matching call?)",
                )
        if rec:  # how long completion blocked the host
            _obs.record("wait", "request", t0, _time.perf_counter() - t0)
        return self.status

    def cancel(self) -> None:
        """MPI_Cancel: the request then COMPLETES with
        status.cancelled=True (MPI requires a subsequent wait/test to
        succeed and report the cancellation)."""
        with self._lock:
            if self.state is not RequestState.ACTIVE:
                return
            self.state = RequestState.COMPLETE
            self.status.cancelled = True
            callbacks = list(self._on_complete)
        for cb in callbacks:
            cb(self)

    @property
    def is_cancelled(self) -> bool:
        return self.status.cancelled

    def free(self) -> None:
        self._on_complete.clear()


def from_future(fut) -> Request:
    """Wrap a ``concurrent.futures.Future`` as a Request: success
    completes with the future's value; failure surfaces the worker's
    exception at test()/wait() (the libnbc error-on-progress contract).
    A bare wait() drives the shared progress hook between bounded
    future polls, so the engine keeps advancing other in-flight work
    instead of this thread sleeping the whole wait out."""
    from concurrent.futures import TimeoutError as _FutTimeout

    completed = threading.Event()

    def block() -> None:
        # poll cadence adapts to whether the engine has work: ticks
        # that advance something keep a 5 ms cadence; an idle engine
        # backs off to 100 ms
        delay = 0.005
        while True:
            progressed = run_progress()
            try:
                fut.result(timeout=delay)  # raises the worker's exception
                break
            except _FutTimeout:
                # the future may have settled during this poll slice (on
                # 3.11+ concurrent.futures.TimeoutError IS the builtin
                # TimeoutError, so a worker's own TimeoutError looks the
                # same): result() on a done future returns or raises the
                # worker's exception at once, never the poll timeout
                if fut.done():
                    continue
                delay = 0.005 if progressed else min(delay * 2, 0.1)
        # Future.set_result wakes result() BEFORE running done callbacks:
        # wait until the callback has completed the request, or wait()'s
        # bare complete() would report value=None for a successful op
        completed.wait()

    def progress(r) -> None:
        run_progress()
        if fut.done() and fut.exception():
            raise fut.exception()

    req = Request(progress_fn=progress, block_fn=block)

    def _done(f) -> None:
        if f.exception() is None:
            req.complete(value=f.result())
        completed.set()

    fut.add_done_callback(_done)
    return req


class GeneralizedRequest(Request):
    """MPI_Grequest_start analogue: user code completes it."""

    def __init__(self, query_fn=None, free_fn=None, cancel_fn=None,
                 extra_state=None) -> None:
        super().__init__()
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn
        self.extra_state = extra_state

    def complete(self, value: Any = None, status: Optional[Status] = None
                 ) -> None:
        if status is None and self._query_fn is not None:
            status = self._query_fn(self.extra_state)
        super().complete(value, status)

    def cancel(self) -> None:
        if self._cancel_fn is not None:
            self._cancel_fn(self.extra_state,
                            self.state is RequestState.COMPLETE)
        super().cancel()

    def free(self) -> None:
        if self._free_fn is not None:
            self._free_fn(self.extra_state)
        super().free()


# ---------------------------------------------------------------------------
# multi-request operations (ompi/request/req_wait.c / req_test.c)
# ---------------------------------------------------------------------------

def test(req: Request) -> Tuple[bool, Optional[Status]]:
    return req.test()


def wait(req: Request) -> Status:
    return req.wait()


def test_all(reqs: Sequence[Request]) -> Tuple[bool, Optional[List[Status]]]:
    # ONE shared tick first: a single engine pass reaps every pending
    # request's progress; then each test() is a cheap completion check
    run_progress()
    if all(r.test()[0] for r in reqs):
        return True, [r.status for r in reqs]
    return False, None


def wait_all(reqs: Sequence[Request]) -> List[Status]:
    run_progress()
    return [r.wait() for r in reqs]


def test_any(reqs: Sequence[Request]
             ) -> Tuple[Optional[int], Optional[Status]]:
    run_progress()  # one tick covers the whole scan
    for i, r in enumerate(reqs):
        done, st = r.test()
        if done and r.state is not RequestState.INACTIVE:
            return i, st
    return None, None


def wait_any(reqs: Sequence[Request]) -> Tuple[int, Status]:
    if not reqs:
        raise MPIError(ErrorCode.ERR_ARG, "wait_any on empty request list")
    # pass 1: anything already done; pass 2: block on the first request
    # that CAN block (device work); host-side requests with no pending
    # completion event cannot finish on their own in driver mode
    i, st = test_any(reqs)
    if i is not None:
        return i, st
    for j, r in enumerate(reqs):
        if r._block_fn is not None and r.state is RequestState.ACTIVE:
            return j, r.wait()
    raise MPIError(
        ErrorCode.ERR_PENDING,
        "wait_any would deadlock: no request is complete, and none has "
        "device work to block on (missing matching call?)",
    )


def wait_some(reqs: Sequence[Request]) -> Tuple[List[int], List[Status]]:
    if all(r.state is RequestState.INACTIVE for r in reqs):
        return [], []  # MPI_Waitsome: outcount undefined, nothing waits
    idx, sts = [], []
    wait_any(reqs)
    for j, r in enumerate(reqs):
        if r.state is RequestState.INACTIVE:
            continue  # MPI_Waitsome ignores inactive requests
        done, _ = r.test()
        if done:
            idx.append(j)
            sts.append(r.status)
    return idx, sts
