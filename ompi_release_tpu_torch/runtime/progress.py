"""Async progress engine — the ``opal_progress`` analogue.

Counterpart of ``ompi_release_tpu/runtime/progress.py``. The reference
hangs its comm engine off one loop: ``opal/runtime/opal_progress.c``
registers per-framework callbacks, every blocked wait spins
``opal_progress()`` until its completion flag flips, and libnbc
(``ompi/mca/coll/libnbc/nbc.c``) advances nonblocking-collective round
schedules from that loop. This module is that engine:

- a REGISTRY of in-flight scheduled operations (one
  :class:`ScheduledOp` per schedule posted by :mod:`coll.nbc`), run
  strictly in per-key (per-communicator) posting order, with a
  per-thread posting ledger so a program's deferred operations drain in
  program order;
- an explicit :meth:`ProgressEngine.progress` TICK that completes
  in-process async requests whose CUDA events have fired (one tick
  advances every pending request: ``request.wait_all``/``test_all`` and
  a bare ``Request.wait()`` call it through the shared progress hook)
  and, when ``deep``, runs each in-flight op's receive-side ``pump``;
- an opt-in DEDICATED PROGRESS THREAD (``progress_thread`` cvar, off by
  default) that claims queued schedules and runs them off the caller;
  ``nbc_hidden_seconds`` measures the run time that overlapped the
  caller. The default is the polling fallback: schedules run at
  ``wait()`` in posting order on the caller's thread.

An op is *claimed* (QUEUED -> RUNNING, exactly once) only when it is the
head of its key's FIFO, so two schedules on one communicator never
interleave. A test()-only completion loop is live in polling mode too:
the second test on a still-queued schedule kicks an on-demand background
drainer (:meth:`ProgressEngine.advance_toward`).

A schedule that carries a CUDA ``device`` runs with that device current
on whichever thread runs it (the progress thread's current device is
otherwise ``cuda:0``).

pvars: ``progress_ticks`` (engine ticks), ``nbc_schedules_inflight``
(posted-but-incomplete schedules), ``nbc_hidden_seconds`` (schedule run
time that overlapped caller work).

Observability: with obs on, each executed schedule is one ``nbc``-layer
span and a tick that progressed something one ``progress_tick`` span;
the flight recorder's ``nbc_inflight`` contributor dumps the in-flight
schedules, and :func:`event_block` arms the stall watchdog around a
blocking wait on a CUDA event. The emit sites are gated on
``_obs.enabled`` and time the host, never the card.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time as _time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..obs import watchdog as _watchdog
from ..request import request as _request
from ..utils import output

_log = output.stream("progress")

_ticks = pvar.counter(
    "progress_ticks",
    "explicit/threaded progress-engine ticks (opal_progress analogue)",
)
_hidden = pvar.timer(
    "nbc_hidden_seconds",
    "nonblocking-schedule run time that overlapped caller compute "
    "(ran before the first wait) instead of blocking the critical path",
)


def register_vars() -> None:
    mca_var.register(
        "progress_thread", "bool", False,
        "Run the dedicated async-progress thread: queued nonblocking "
        "collective schedules execute off the caller (true "
        "compute/comm overlap). Off (default) = polling fallback: "
        "schedules advance when the caller ticks progress() or waits, "
        "in posting order — deterministic for single-threaded tests",
    )
    mca_var.register(
        "progress_poll_us", "int", 500,
        "Idle poll period of the progress thread in microseconds "
        "(bounds the latency between a request's completion and the "
        "engine reaping it when no schedule is runnable)",
    )


register_vars()  # idempotent; cvars must exist before the first post


#: ScheduledOp lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"


class ScheduledOp:
    """One in-flight scheduled operation (a libnbc handle analogue).

    ``key`` serializes execution: ops sharing a key (one communicator)
    run strictly in posting order, never concurrently. ``fn`` is the
    whole schedule; ``pump`` (optional) is a nonblocking receive-side
    tick run by deep engine ticks; ``device`` (optional) is the CUDA
    device made current while ``fn`` runs.
    """

    __slots__ = ("seq", "key", "name", "cid", "fn", "args", "kw",
                 "pump", "device", "state", "claimed_by", "poster", "polls",
                 "result", "error", "done", "callbacks", "t_post",
                 "t_start", "t_done", "t_first_wait")

    def __init__(self, key: Any, name: str, fn: Callable, *,
                 cid: int = -1, args: Tuple = (), kw: Optional[Dict] = None,
                 pump: Optional[Callable[[], int]] = None,
                 device: Any = None) -> None:
        self.seq = 0  # assigned by post()
        self.key = key
        self.name = name
        self.cid = cid
        self.fn = fn
        self.args = args
        self.kw = kw or {}
        self.pump = pump
        self.device = device
        self.state = QUEUED
        self.claimed_by: Optional[int] = None
        self.poster: Optional[int] = None  # assigned by post()
        self.polls = 0  # consecutive test()-style advances (kick gate)
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        #: completion callbacks, run BEFORE done is set (a waiter must
        #: observe the bound request already completed-with-value)
        self.callbacks: List[Callable] = []
        self.t_post = _time.perf_counter()
        self.t_start = 0.0
        self.t_done = 0.0
        self.t_first_wait: Optional[float] = None

    def hidden_seconds(self) -> float:
        """The part of this schedule's run the poster spent elsewhere:
        0 when the first wait came before the run started (polling
        mode); the whole run when it finished before the first wait.
        Meaningful once the op is DONE; 0 before."""
        if not self.t_done:
            return 0.0
        tw = self.t_first_wait
        if tw is not None and tw <= self.t_start:
            return 0.0
        end = self.t_done if tw is None else min(self.t_done, tw)
        return max(0.0, end - self.t_start)

    def describe(self) -> Dict[str, Any]:
        """One line naming the schedule, its state and its age."""
        now = _time.perf_counter()
        return {
            "name": self.name, "cid": self.cid, "seq": self.seq,
            "state": self.state, "claimed_by": self.claimed_by,
            "posted_s_ago": round(now - self.t_post, 3),
            "running_s": (round(now - self.t_start, 3)
                          if self.state == RUNNING else 0.0),
            "waited_on": self.t_first_wait is not None,
        }


def _on_device(device):
    """The op's CUDA device made current for its run (nothing for CPU
    schedules or none)."""
    if device is None or getattr(device, "type", None) != "cuda":
        return contextlib.nullcontext()
    import torch

    return torch.cuda.device(device)


class ProgressEngine:
    """Process-global progress engine (one per controller process)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._seq = itertools.count(1)
        #: key -> FIFO of not-yet-done ops (head = next to run)
        self._queues: Dict[Any, deque] = {}
        #: poster thread id -> ops in posting order (the drain ledger)
        self._posted: Dict[int, List[ScheduledOp]] = {}
        #: seq -> op, every posted-but-incomplete op (the registry the
        #: nbc_schedules_inflight pvar reads)
        self._inflight: Dict[int, ScheduledOp] = {}
        #: token -> weakref of in-process async Requests the tick
        #: completes when their events fire (completion pops its own
        #: token, so ticks stay O(outstanding))
        self._poll: Dict[int, weakref.ref] = {}
        #: keys with an active test()-kicked background drainer
        self._kicked: set = set()
        self._tls = threading.local()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- registry ----------------------------------------------------------
    def inflight_count(self) -> int:
        return len(self._inflight)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            ops = sorted(self._inflight.values(), key=lambda o: o.seq)
        return [op.describe() for op in ops]

    # -- posting -----------------------------------------------------------
    def post(self, op: ScheduledOp) -> ScheduledOp:
        """Enqueue one scheduled op (never blocks, never executes)."""
        tid = threading.get_ident()
        with self._lock:
            op.seq = next(self._seq)
            op.poster = tid
            self._queues.setdefault(op.key, deque()).append(op)
            self._posted.setdefault(tid, []).append(op)
            self._inflight[op.seq] = op
            self._cond.notify_all()
        self.ensure_thread()
        return op

    # -- execution ---------------------------------------------------------
    def executing(self) -> Optional[ScheduledOp]:
        """The op the CURRENT thread is executing, if any (nested
        collective detection)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _unlink_locked(self, op: ScheduledOp) -> None:
        """Drop a finished op from its queue, the registry and its
        poster's ledger. Caller holds the lock."""
        q = self._queues.get(op.key)
        if q:
            try:
                q.remove(op)
            except ValueError:
                pass
            if not q:
                self._queues.pop(op.key, None)
        self._inflight.pop(op.seq, None)
        # an op completed by another thread must not pile up in a
        # ledger its poster may never scan again
        ledger = self._posted.get(op.poster)
        if ledger is not None:
            try:
                ledger.remove(op)
            except ValueError:
                pass
            if not ledger:
                self._posted.pop(op.poster, None)

    @staticmethod
    def _finish(op: ScheduledOp) -> None:
        """Callbacks BEFORE the event: a thread woken by ``done`` must
        find the bound request already completed with its value."""
        for cb in list(op.callbacks):
            try:
                cb(op)
            except Exception as e:  # a callback must not kill the engine
                _log.verbose(1, f"nbc completion callback failed: {e}")
        op.done.set()

    def _execute(self, op: ScheduledOp) -> None:
        """Run one claimed op to completion on this thread."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(op)
        op.t_start = _time.perf_counter()
        rec = _obs.enabled  # capture once: flag may flip mid-run
        try:
            with _on_device(op.device):
                op.result = op.fn(*op.args, **op.kw)
        except BaseException as e:
            op.error = e
        finally:
            stack.pop()
            t_done = op.t_done = _time.perf_counter()
            with self._lock:
                op.state = DONE
                self._unlink_locked(op)
                self._cond.notify_all()
            hidden = op.hidden_seconds()
            if hidden > 0:
                _hidden.add(hidden)
            if rec and _obs.enabled:
                _obs.record("nbc_" + op.name, "nbc", op.t_start,
                            t_done - op.t_start, comm_id=op.cid)
            self._finish(op)

    def _claim_locked(self, op: ScheduledOp) -> bool:
        """Claim ``op`` if it is the QUEUED head of its key's FIFO.
        Caller holds the lock."""
        q = self._queues.get(op.key)
        if not q or q[0] is not op or op.state != QUEUED:
            return False
        op.state = RUNNING
        op.claimed_by = threading.get_ident()
        return True

    def _next_runnable(self, op: ScheduledOp,
                       tid: int) -> Optional[ScheduledOp]:
        """Claim the op this thread should run next on the way to
        ``op``: the head of the queue owning the EARLIEST not-done op
        this thread posted at or before ``op`` (program posting order),
        else ``op``'s own queue head. Returns a CLAIMED op, or None
        (the blocker runs elsewhere)."""
        with self._lock:
            posted = self._posted.get(tid)
            cand = None
            if posted:
                posted[:] = [o for o in posted if o.state != DONE]
                # skip ops RUNNING on THIS thread: they sit beneath us on
                # the stack (a nested wait from inside a schedule) and
                # cannot progress until we return
                for o in posted:
                    if o.seq > op.seq:
                        break
                    if o.state == RUNNING and o.claimed_by == tid:
                        continue
                    cand = o
                    break
            if cand is None:
                cand = op if op.state != DONE else None
            if cand is None:
                return None
            q = self._queues.get(cand.key)
            head = q[0] if q else None
            if head is not None and self._claim_locked(head):
                return head
            return None

    def wait(self, op: ScheduledOp) -> Any:
        """Complete ``op``: drain earlier same-thread/same-key ops in
        posting order (polling mode), or park on the completion event
        while another thread runs it. Re-raises the schedule's error;
        returns its result."""
        if op.t_first_wait is None:
            op.t_first_wait = _time.perf_counter()
        tid = threading.get_ident()
        while not op.done.is_set():
            target = self._next_runnable(op, tid)
            if target is not None:
                self._execute(target)
                continue
            with self._lock:
                evicted = (op.state != DONE
                           and op.seq not in self._inflight)
            if evicted:
                from ..utils.errors import ErrorCode, MPIError

                raise MPIError(
                    ErrorCode.ERR_REQUEST,
                    f"progress engine shut down with schedule "
                    f"'{op.name}' still pending (finalize with "
                    "outstanding nonblocking collectives?)",
                )
            if op.done.wait(0.02):
                break
            self.progress()
        if op.error is not None:
            raise op.error
        return op.result

    def advance_toward(self, op: ScheduledOp) -> int:
        """Nonblocking progress toward ``op`` — the MPI_Test progress
        rule. The SECOND consecutive test() on a still-queued schedule
        kicks an on-demand background drainer for its queue (the first
        does not: ``Request.wait()`` performs one internal test before
        blocking, so wait-only users never see a thread); every test()
        also runs the shallow tick."""
        if op.done.is_set():
            return 0
        op.polls += 1
        if op.polls >= 2 and not self.thread_mode() \
                and self.executing() is None:
            self._kick(op)
        return self.progress(deep=False)  # test() must never park

    def _kick(self, op: ScheduledOp) -> None:
        """Ensure one background drainer runs ``op``'s queue until the
        op completes (one drainer per key at a time)."""
        with self._lock:
            if op.state == DONE or op.key in self._kicked:
                return
            self._kicked.add(op.key)
        threading.Thread(target=self._kick_loop, args=(op,),
                         daemon=True,
                         name=f"nbc-kick-{op.name}").start()

    def _kick_loop(self, op: ScheduledOp) -> None:
        try:
            while not op.done.is_set():
                target = None
                with self._lock:
                    if op.state != DONE and op.seq not in self._inflight:
                        return  # evicted (engine shutdown): don't spin
                    q = self._queues.get(op.key)
                    head = q[0] if q else None
                    if head is not None and self._claim_locked(head):
                        target = head
                if target is not None:
                    self._execute(target)
                    continue
                op.done.wait(0.05)
        finally:
            with self._lock:
                self._kicked.discard(op.key)

    def fail_queued(self, key: Any, exc_factory: Callable[[], BaseException]
                    ) -> int:
        """Complete every still-QUEUED op on ``key`` in error WITHOUT
        running it (the ULFM revoke interrupt). A RUNNING op is left
        alone. Returns how many ops were failed."""
        failed: List[ScheduledOp] = []
        with self._lock:
            q = self._queues.get(key)
            if not q:
                return 0
            for op in list(q):
                if op.state != QUEUED:
                    continue
                op.state = DONE
                op.error = exc_factory()
                self._unlink_locked(op)
                failed.append(op)
            self._cond.notify_all()
        for op in failed:
            self._finish(op)
        return len(failed)

    def drain_key(self, key: Any) -> None:
        """Complete every posted op on one key, in order (the comm free
        and shutdown path). A synchronous wait: the ops are stamped as
        waited-on, so their run time never counts as hidden."""
        while True:
            with self._lock:
                q = self._queues.get(key)
                head = q[0] if q else None
                if head is None:
                    return
                if head.t_first_wait is None:
                    head.t_first_wait = _time.perf_counter()
                claimed = self._claim_locked(head)
            if claimed:
                self._execute(head)
            else:
                head.done.wait(0.05)

    # -- the tick ----------------------------------------------------------
    def progress(self, deep: bool = True) -> int:
        """One engine tick: complete in-process async requests whose
        events fired and, when ``deep``, run every in-flight op's pump.
        The implicit hook behind request test()/test_all() runs shallow.
        Never executes a schedule (that belongs to wait(), the kick
        drainers and the progress thread) and is reentrancy-safe (a tick
        from inside a tick is a no-op). Returns how many items
        progressed."""
        if getattr(self._tls, "ticking", False):
            return 0
        self._tls.ticking = True
        rec = _obs.enabled
        t0 = _time.perf_counter() if rec else 0.0
        try:
            _ticks.add()
            n = 0
            if deep:
                with self._lock:
                    pumps = {}
                    for o in self._inflight.values():
                        if o.pump is not None and o.key not in pumps:
                            pumps[o.key] = o.pump
                for fn in pumps.values():
                    try:
                        n += int(fn() or 0)
                    except Exception as e:  # a dead pump is not fatal
                        _log.verbose(2, f"progress pump failed: {e}")
            n += self._poll_ready()
            if n and rec and _obs.enabled:
                _obs.record("progress_tick", "nbc", t0,
                            _time.perf_counter() - t0)
            return n
        finally:
            self._tls.ticking = False

    def add_poll(self, req) -> None:
        """Track an in-process async Request: ticks (and the progress
        thread) complete it the moment its device work is done. The
        entry is pruned the moment the request completes through ANY
        path (a bare wait() included)."""
        with self._lock:
            token = next(self._seq)
            self._poll[token] = weakref.ref(req)
            self._cond.notify_all()
        req.on_complete(lambda _r: self._discard_poll(token))
        self.ensure_thread()

    def _discard_poll(self, token: int) -> None:
        with self._lock:
            self._poll.pop(token, None)

    def _poll_ready(self) -> int:
        with self._lock:
            items = list(self._poll.items())
        if not items:
            return 0
        completed = 0
        dead = []
        for token, ref in items:
            req = ref()
            done = True  # a collected request needs no more polling
            if req is not None:
                try:
                    done = req.poll()
                except Exception:
                    pass  # surfaced at the request's own wait/test
            if done:
                completed += req is not None
                dead.append(token)
        if dead:
            with self._lock:
                for token in dead:
                    self._poll.pop(token, None)
        return completed

    # -- the opt-in thread -------------------------------------------------
    @staticmethod
    def thread_mode() -> bool:
        return bool(mca_var.get("progress_thread", False))

    def ensure_thread(self) -> None:
        """Start the dedicated progress thread iff the cvar asks for
        one (lazy: posting with the cvar flipped mid-run works; the
        loop retires itself when the cvar flips back off)."""
        if not self.thread_mode():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive() \
                    and not self._stop.is_set():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._thread_loop, args=(self._stop,),
                daemon=True, name="nbc-progress",
            )
            self._thread.start()

    def _claim_next(self) -> Optional[ScheduledOp]:
        with self._lock:
            for op in sorted(self._inflight.values(),
                             key=lambda o: o.seq):
                if self._claim_locked(op):
                    return op
        return None

    def _thread_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if not self.thread_mode():
                break  # cvar flipped off: polling mode resumes
            op = self._claim_next()
            if op is not None:
                self._execute(op)
                continue
            self.progress()
            period = max(0.0002, min(
                0.05, int(mca_var.get("progress_poll_us", 500)) / 1e6))
            with self._cond:
                if not self._inflight and not self._poll:
                    self._cond.wait(period * 20)
                else:
                    self._cond.wait(period)
        with self._lock:
            if self._thread is threading.current_thread():
                self._thread = None

    def shutdown(self, timeout: float = 5.0, drain: bool = True) -> None:
        """Finalize-time teardown: stop the thread, DRAIN queued
        schedules, give RUNNING ones a bounded wait, then clear. The
        engine stays usable — a later post() re-arms it."""
        with self._lock:
            self._stop.set()
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        if drain:
            while True:
                with self._lock:
                    keys = [k for k, q in self._queues.items() if q]
                if not keys:
                    break
                for key in keys:
                    self.drain_key(key)  # errors land on the ops
        with self._lock:
            running = [o for o in self._inflight.values()
                       if o.state == RUNNING]
        deadline = _time.monotonic() + timeout
        for op in running:
            op.done.wait(max(0.0, deadline - _time.monotonic()))
        with self._lock:
            self._queues.clear()
            self._posted.clear()
            self._inflight.clear()
            self._poll.clear()
            self._thread = None


#: THE engine (opal_progress is process-global; so is this)
ENGINE = ProgressEngine()


def engine() -> ProgressEngine:
    return ENGINE


def event_block(ev, what: str, comm_id: int = -1) -> Callable[[], None]:
    """A Request block function waiting on the CUDA event ``ev`` (the
    in-process async dispatch's completion): with the stall watchdog on
    the wait is armed, so a card that never reaches the event dumps a
    postmortem naming ``what``."""

    def block() -> None:
        tok = None
        if _watchdog.enabled:
            tok = _watchdog.arm(what, comm_id=comm_id,
                                info={"wait": "cuda_event"})
        try:
            ev.synchronize()
        finally:
            if tok is not None:
                _watchdog.disarm(tok)

    return block


_watchdog.add_contributor("nbc_inflight", lambda: ENGINE.snapshot())


pvar.PVARS.register(
    "nbc_schedules_inflight", pvar.PvarClass.LEVEL,
    "nonblocking collective schedules posted but not yet complete",
    getter=lambda: ENGINE.inflight_count(),
)

# one shared tick advances EVERY pending request: wait_all/test_all and a
# bare Request.wait() drive the engine through this hook. SHALLOW tick:
# the hook runs inside nonblocking test paths.
_request.register_progress_hook(lambda: ENGINE.progress(deep=False))
