"""Stall watchdog + postmortem flight recorder.

The operator question that actually pages people — "the job is stuck;
who is waiting in what?" — needs an answer that survives the hang: a
hung job leaves no artifact, and the evidence (posted/unexpected
queues, hier round state, window lock tables, thread stacks) dies with
the process or is unreachable from outside it.

This module keeps a registry of **armed waits**: every blocking
collective / p2p / RMA wait registers itself (``arm``/``disarm``, one
module-attribute check when off) and a monitor thread dumps a
**postmortem file** the moment any wait exceeds ``obs_stall_timeout``
seconds. The dump carries everything a ``tpu-doctor`` postmortem needs:

  - the stalled wait(s): op, comm, how long, and who has not arrived
  - the journal tail (most recent spans, flow ids included)
  - the full pvar snapshot
  - the PML posted/unexpected queues (``tools/msgq.py`` — the message
    queue debugging DLL's data, ``ompi/debuggers``)
  - layer contributors: hier round state, window-service lock tables
  - per-thread Python stacks (``faulthandler``)
  - the rank identity + OOB clock offset so ``tpu-doctor`` can merge
    postmortems from several ranks onto one timeline

The same dump fires on SIGUSR1 (``kill -USR1 <pid>`` against a live
rank — the process continues) and, stacks-only, on fatal signals
(SIGSEGV/SIGFPE/SIGABRT/SIGBUS via ``faulthandler.enable``).

Cost discipline: ``enabled`` is True only when the obs plane is on AND
``obs_stall_timeout`` > 0; every call site gates on it, so the off
path is one attribute check — the plane's cost contract.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..mca import pvar as _pvar
from ..mca import var as _var

#: THE gate: arm/disarm sites check this and do nothing else when
#: False. Recomputed by refresh() on obs enable/disable.
enabled: bool = False

_timeout: float = 0.0
_tokens: Dict[int, "WaitToken"] = {}
_tokens_lock = threading.Lock()
_token_ids = itertools.count(1)
_monitor: Optional[threading.Thread] = None
_monitor_stop = threading.Event()
_dump_lock = threading.Lock()
_dump_seq = itertools.count(1)
#: backstop against a pathological stall storm filling the disk —
#: applies ONLY to watchdog-initiated stall dumps; operator-requested
#: SIGUSR1 dumps are human-bounded and always write
MAX_STALL_DUMPS = 8
_stall_dumps = 0

#: dump contributors: (name -> zero-arg callable returning JSON-able
#: state). Layers register the state only they can see (hier round
#: tables, window lock tables); contributors run best-effort at dump
#: time and a failing one is reported, never fatal.
_contributors: Dict[str, Callable[[], Any]] = {}

_stalls_detected = _pvar.counter(
    "obs_stalls_detected",
    "waits that exceeded obs_stall_timeout (each dumps a postmortem)",
)
_postmortems_written = _pvar.counter(
    "obs_postmortems_written", "postmortem files written"
)


def register_vars() -> None:
    _var.register(
        "obs_stall_timeout", "float", 0.0,
        "Seconds a monitored collective/p2p/RMA wait may block before "
        "the flight recorder dumps a postmortem (0 = watchdog off; "
        "needs the obs plane enabled)",
    )
    _var.register(
        "obs_postmortem_dir", "str", "",
        "Directory for postmortem dumps (stall watchdog, SIGUSR1, "
        "fatal-signal stacks); empty = "
        "$TMPDIR/ompitpu-postmortem-<uid>",
    )
    _var.register(
        "obs_dump_dir", "str", "",
        "When set (and obs is enabled), every rank writes its journal "
        "+ clock offset to <dir>/journal-p<pidx>.json at finalize — "
        "the per-rank input tpu-doctor merges into one Perfetto trace",
    )


register_vars()  # idempotent; cvars must exist before any refresh()


class WaitToken:
    __slots__ = ("id", "op", "comm_id", "peer", "t0", "info", "dumped",
                 "detected")

    def __init__(self, op: str, comm_id: int, peer: int,
                 info: Any) -> None:
        self.id = next(_token_ids)
        self.op = op
        self.comm_id = comm_id
        self.peer = peer
        self.t0 = time.perf_counter()
        #: dict, or zero-arg callable resolved at dump time (so a
        #: pending-peer set reflects arrivals since arming)
        self.info = info
        self.dumped = False
        self.detected = False  # counted once, even across dump retries

    def describe(self) -> Dict[str, Any]:
        info = self.info
        if callable(info):
            try:
                info = info()
            except Exception as e:
                info = {"error": f"{type(e).__name__}: {e}"}
        return {"op": self.op, "comm": self.comm_id, "peer": self.peer,
                "waited_s": round(time.perf_counter() - self.t0, 3),
                "info": info}


def refresh(obs_enabled: Optional[bool] = None) -> None:
    """Recompute the gate from the obs flag + obs_stall_timeout."""
    global enabled, _timeout
    if obs_enabled is None:
        from . import is_enabled

        obs_enabled = is_enabled()
    _timeout = float(_var.get("obs_stall_timeout", 0.0) or 0.0)
    enabled = bool(obs_enabled and _timeout > 0)
    if not enabled:
        # retire the monitor thread: arm sites check the gate, so no
        # new tokens arrive, and a forever-polling daemon would
        # outlive the feature (arm() restarts it on re-enable)
        _monitor_stop.set()
    else:
        # waits armed BEFORE a disable->enable flip can never re-arm
        # (their threads are blocked inside the wait), so arm() alone
        # won't resurrect the monitor for exactly the hung wait the
        # operator re-enabled obs to diagnose
        with _tokens_lock:
            have_tokens = bool(_tokens)
        if have_tokens:
            _ensure_monitor()


def arm(op: str, comm_id: int = -1, peer: int = -1,
        info: Any = None) -> WaitToken:
    """Register a blocking wait with the monitor. Callers gate on
    ``watchdog.enabled`` themselves (the one-attr-check contract) and
    MUST pair with disarm() in a finally block."""
    tok = WaitToken(op, comm_id, peer, info)
    with _tokens_lock:
        _tokens[tok.id] = tok
    _ensure_monitor()
    return tok


def disarm(tok: Optional[WaitToken]) -> None:
    if tok is None:
        return
    with _tokens_lock:
        _tokens.pop(tok.id, None)


def active_waits() -> List[Dict[str, Any]]:
    with _tokens_lock:
        toks = list(_tokens.values())
    return [t.describe() for t in toks]


def add_contributor(name: str, fn: Callable[[], Any]) -> None:
    """Register a dump-time state contributor (idempotent by name)."""
    _contributors[name] = fn


def _ensure_monitor() -> None:
    global _monitor, _monitor_stop
    if (_monitor is not None and _monitor.is_alive()
            and not _monitor_stop.is_set()):
        return  # hot-path fast check; the lock below settles races
    with _tokens_lock:
        if (_monitor is not None and _monitor.is_alive()
                and not _monitor_stop.is_set()):
            return
        # each monitor generation OWNS its stop event: a disable ->
        # enable flip must not leave a dying-but-alive old thread
        # absorbing the cleared event (no monitor for an armed wait)
        # or resurrect the old thread alongside a new one
        _monitor_stop = threading.Event()
        _monitor = threading.Thread(target=_monitor_loop,
                                    args=(_monitor_stop,), daemon=True,
                                    name="obs-stall-watchdog")
        _monitor.start()


def _monitor_loop(stop: threading.Event) -> None:
    # after a FAILED dump (read-only/full postmortem dir) retries back
    # off exponentially: without this the loop would re-run the heavy
    # dump path and warn every poll period for the rest of the hang
    retry_at, backoff = 0.0, 1.0
    while not stop.is_set():
        period = max(0.05, min(0.5, (_timeout or 1.0) / 4))
        if stop.wait(period):
            return
        if not enabled:
            continue
        now = time.perf_counter()
        if now < retry_at:
            continue
        with _tokens_lock:
            stalled = [t for t in _tokens.values()
                       if not t.dumped and now - t.t0 > _timeout]
            fresh = sum(1 for t in stalled if not t.detected)
            for t in stalled:
                t.detected = True
                t.dumped = True  # one postmortem per stalled wait
        if stalled:
            if fresh:
                _stalls_detected.add(fresh)
            # the recorder must never take the job down — but a FAILED
            # dump (read-only/full postmortem dir) must still leave a
            # log line, so the write attempt and the reporting are
            # guarded separately
            path, dump_err = "", None
            try:
                path = dump_postmortem("stall", stalled=stalled)
                backoff = 1.0
            except Exception as e:
                dump_err = f"{type(e).__name__}: {e}"
                # a transient failure (dir full, read-only mount) must
                # not permanently consume each wait's one postmortem:
                # un-mark so a LATER poll retries once the disk heals
                # (gated by the backoff above, not every period)
                with _tokens_lock:
                    for t in stalled:
                        t.dumped = False
                retry_at = time.perf_counter() + backoff
                backoff = min(backoff * 2, 30.0)
            try:
                from ..utils import output

                if dump_err is not None:
                    detail = f"postmortem dump FAILED: {dump_err}"
                elif path:
                    detail = f"postmortem -> {path}"
                else:
                    detail = (f"postmortem SUPPRESSED (cap of "
                              f"{MAX_STALL_DUMPS} stall dumps reached; "
                              "the first dumps hold the story)")
                output.stream("obs").warn(
                    f"stall watchdog: {len(stalled)} wait(s) exceeded "
                    f"obs_stall_timeout={_timeout:g}s "
                    f"({', '.join(t.op for t in stalled)}); {detail}")
            except Exception:
                pass


def postmortem_dir() -> str:
    d = str(_var.get("obs_postmortem_dir", "") or "")
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         f"ompitpu-postmortem-{os.getuid()}")
    os.makedirs(d, exist_ok=True)
    return d


def _rank_identity() -> Dict[str, Any]:
    from . import rank_identity

    return rank_identity()


def _thread_stacks() -> List[str]:
    """Every thread's Python stack via faulthandler (the only dumper
    that works mid-deadlock: it never takes locks)."""
    import faulthandler

    fd, path = tempfile.mkstemp(prefix="ompitpu-stacks-", suffix=".txt")
    try:
        with os.fdopen(fd, "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
        with open(path) as f:
            return f.read().splitlines()
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def dump_postmortem(reason: str,
                    stalled: Optional[List[WaitToken]] = None,
                    path: Optional[str] = None) -> str:
    """Write one postmortem JSON file; returns its path. Everything
    inside is best-effort: a hung subsystem must not be able to hang
    its own flight recorder."""
    # NOTE: the obs package binds the attribute ``journal`` to the
    # Journal INSTANCE, so ``from . import journal`` would shadow the
    # submodule — import the instance through the submodule directly
    from .journal import JOURNAL as _journal

    global _stall_dumps
    with _dump_lock:
        n = next(_dump_seq)
        counts_against_cap = reason == "stall" and path is None
        if counts_against_cap and _stall_dumps >= MAX_STALL_DUMPS:
            return ""  # flood backstop (stall storms only)
        ident = _rank_identity()
        doc: Dict[str, Any] = {
            "reason": reason,
            "time_unix": time.time(),
            "perf_counter": time.perf_counter(),
            "rank": ident,
            "obs_stall_timeout": _timeout,
        }
        try:
            from . import _clock_state

            doc["clock"] = dict(_clock_state)
        except Exception:
            pass
        if stalled:
            doc["stalled"] = [t.describe() for t in stalled]
        try:
            doc["active_waits"] = active_waits()
        except Exception as e:
            doc["active_waits"] = f"unavailable: {e}"
        try:
            doc["journal_tail"] = [
                s.asdict() for s in _journal.snapshot()[-256:]
            ]
        except Exception as e:
            doc["journal_tail"] = f"unavailable: {e}"
        try:
            doc["pvars"] = _pvar.PVARS.read_all()
        except Exception as e:
            doc["pvars"] = f"unavailable: {e}"
        try:
            from ..tools import msgq

            doc["msg_queues"] = msgq.dump_all()
        except Exception as e:
            doc["msg_queues"] = f"unavailable: {e}"
        for name, fn in list(_contributors.items()):
            try:
                doc[name] = fn()
            except Exception as e:
                doc[name] = f"unavailable: {type(e).__name__}: {e}"
        try:
            doc["thread_stacks"] = _thread_stacks()
        except Exception as e:
            doc["thread_stacks"] = f"unavailable: {e}"
        if path is None:
            ident_tag = f"p{ident.get('pidx', 'x')}-{os.getpid()}"
            path = os.path.join(
                postmortem_dir(),
                f"postmortem-{ident_tag}-{reason}-{n}.json",
            )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)
        try:
            # the full compiled-fire flight recorder rides beside the
            # postmortem (the inline ledger_tail contributor carries
            # only the newest records): tpu-doctor expands it into
            # synthetic spans for the stalled rank's compiled traffic
            from . import ledger as _ledger

            if _ledger.records():
                pidx = ident.get("pidx", 0)
                _ledger.dump(os.path.join(
                    os.path.dirname(path), f"ledger-p{pidx}.json"))
        except Exception:
            pass  # best-effort, like every other dump section
        try:
            # likewise the native event ring (zero-copy datapath
            # fragments): tpu-doctor expands nativeev-p*.json into
            # wire-layer spans with paired flow ids — the stalled
            # rank's byte-path story, even though Python never saw
            # the bytes
            from . import nativeev as _nativeev

            if _nativeev.get_ring() is not None:
                pidx = ident.get("pidx", 0)
                _nativeev.dump(os.path.join(
                    os.path.dirname(path), f"nativeev-p{pidx}.json"))
        except Exception:
            pass  # best-effort, like every other dump section
        if counts_against_cap:
            # budget counts dumps that REACHED disk: a failed write
            # (raised above) must not spend it, or a transient full
            # disk could silently suppress every later real stall
            _stall_dumps += 1
        _postmortems_written.add()
        return path


_signals_installed = False


def install_signal_handlers() -> None:
    """SIGUSR1 -> full postmortem (process continues); fatal signals
    (SIGSEGV/SIGFPE/SIGABRT/SIGBUS) -> faulthandler stack dump into the
    postmortem dir. Main-thread only (signal.signal's own rule); a
    non-main caller is a silent no-op so library init never breaks."""
    global _signals_installed
    if _signals_installed:
        return
    import signal as _signal

    if threading.current_thread() is not threading.main_thread():
        return
    try:
        import faulthandler

        crash_path = os.path.join(
            postmortem_dir(), f"crash-stacks-{os.getpid()}.txt")
        _crash_file = open(crash_path, "w")
        faulthandler.enable(file=_crash_file, all_threads=True)
        # keep a module ref so the fd outlives this frame
        globals()["_crash_file"] = _crash_file

        # chain: an application using SIGUSR1 for its own trigger
        # (checkpoint-now, log rotate) keeps working under obs —
        # SIG_DFL/SIG_IGN are ints, so `callable` filters them
        prev = _signal.getsignal(_signal.SIGUSR1)
        chain = prev if callable(prev) else None

        # the dump must NOT run in signal context: the handler
        # interrupts the main thread between bytecodes, and
        # dump_postmortem takes non-reentrant locks the interrupted
        # frame may hold (journal._lock inside record(), _tokens_lock,
        # window-service state locks via contributors) — dumping
        # inline would deadlock the rank the poke was meant to
        # diagnose. The handler only sets an event; this worker
        # thread does the dump.
        usr1_event = threading.Event()

        def usr1_worker() -> None:
            while True:
                usr1_event.wait()
                usr1_event.clear()
                try:
                    dump_postmortem("sigusr1")
                except Exception:
                    pass

        threading.Thread(target=usr1_worker, daemon=True,
                         name="obs-sigusr1-dumper").start()

        def on_usr1(signum, frame):
            usr1_event.set()
            if chain is not None:
                chain(signum, frame)

        _signal.signal(_signal.SIGUSR1, on_usr1)
        _signals_installed = True
    except (ValueError, OSError):
        pass  # exotic embedding (no usable signals): diagnosis only
