"""Event-driven job/proc state machine — the ``orte/mca/state`` analogue
(the port's own copy of ``ompi_release_tpu/runtime/state.py``).

The reference drives every lifecycle transition through an explicit FSM
(``orte/mca/state/state.h:87,148,242``; state codes
``orte/mca/plm/plm_types.h:47-130``): states are *activated*, which
posts callbacks registered for that state. We keep the explicit-states
idea for observability (and its test value: the fault injector and
errmgr hook in via states) while replacing libevent with synchronous
in-order dispatch plus an optional thread-pool for async callbacks —
the control plane is host Python; the data plane never goes through
here.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import output

_log = output.stream("state")


class JobState(enum.IntEnum):
    """Job lifecycle states (mirrors ORTE_JOB_STATE_*, plm_types.h:113-151)."""

    UNDEF = 0
    INIT = 1
    ALLOCATE = 2
    MAP = 3
    SETUP = 4
    LAUNCH_DAEMONS = 5
    DAEMONS_REPORTED = 6
    VM_READY = 7
    LAUNCH_APPS = 8
    RUNNING = 9
    REGISTERED = 10  # all procs completed modex
    TERMINATED = 11
    ABORTED = 12
    FAILED_TO_START = 13
    RESTART = 14


class ProcState(enum.IntEnum):
    """Process/participant states (mirrors ORTE_PROC_STATE_*, plm_types.h:47-91)."""

    UNDEF = 0
    INIT = 1
    RUNNING = 2
    REGISTERED = 3
    IOF_COMPLETE = 4
    WAITPID_FIRED = 5
    TERMINATED = 6
    ABORTED = 7
    FAILED_TO_START = 8
    COMM_FAILED = 9
    SENSOR_BOUND_EXCEEDED = 10
    HEARTBEAT_FAILED = 11
    LIFELINE_LOST = 12
    UNABLE_TO_SEND_MSG = 13


Callback = Callable[[Any], None]


class StateMachine:
    """Ordered-callback state machine with transition history.

    ``register(state, cb, priority)`` mirrors ``orte_state.add_job_state``;
    ``activate(state, data)`` mirrors ``ORTE_ACTIVATE_JOB_STATE``.
    Callbacks run highest-priority first, synchronously, in activation
    order (the reference posts to an event base; we are single-threaded
    on the control path and keep strict ordering for determinism).
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._callbacks: Dict[int, List[Tuple[int, Callback]]] = {}
        self._history: List[Tuple[float, int, Any]] = []
        self._current: Optional[int] = None
        self._lock = threading.RLock()
        self._error_states: set = set()

    def register(self, state: int, cb: Callback, priority: int = 0) -> None:
        with self._lock:
            self._callbacks.setdefault(int(state), []).append((priority, cb))
            self._callbacks[int(state)].sort(key=lambda t: -t[0])

    def mark_error_state(self, state: int) -> None:
        """States routed to the errmgr (errmgr registers for them)."""
        with self._lock:
            self._error_states.add(int(state))

    def activate(self, state: int, data: Any = None) -> None:
        with self._lock:
            self._current = int(state)
            self._history.append((time.time(), int(state), data))
            cbs = list(self._callbacks.get(int(state), ()))
        _log.verbose(2, f"{self.name}: activate {self._fmt(state)}")
        for _, cb in cbs:
            cb(data)

    def _fmt(self, state: int) -> str:
        for E in (JobState, ProcState):
            try:
                return E(int(state)).name
            except ValueError:
                continue
        return str(state)

    @property
    def current(self) -> Optional[int]:
        return self._current

    def history(self) -> List[Tuple[float, int, Any]]:
        with self._lock:
            return list(self._history)

    def visited(self, state: int) -> bool:
        return any(s == int(state) for _, s, _ in self.history())
