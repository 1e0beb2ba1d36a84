"""Performance variables (pvars): runtime counters exposed for tools
(the port's own copy of ``ompi_release_tpu/mca/pvar.py``).

Analogue of ``opal/mca/base/mca_base_pvar.c`` + the MPI_T performance
variable interface (``ompi/mpi/tool/``): components register named
counters/timers/levels; tools (``tpu_info``, tracing layer) read and reset
them without recompiling anything.
"""

from __future__ import annotations

import enum
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class PvarClass(enum.Enum):
    COUNTER = "counter"        # monotonically increasing
    LEVEL = "level"            # current utilization level
    HIGHWATERMARK = "highwatermark"
    TIMER = "timer"            # accumulated seconds
    STATE = "state"            # discrete state value
    HISTOGRAM = "histogram"    # log2-bucketed distribution
    AGGREGATE = "aggregate"    # count/sum/min/max summary


class Pvar:
    def __init__(self, name: str, pclass: PvarClass, help: str = "",
                 getter: Optional[Callable[[], Any]] = None) -> None:
        self.name = name
        self.pclass = pclass
        self.help = help
        self._value: float = 0
        self._getter = getter
        self._lock = threading.Lock()

    def add(self, delta: float = 1) -> None:
        with self._lock:
            self._value += delta

    def set(self, value: float) -> None:
        with self._lock:
            if self.pclass is PvarClass.HIGHWATERMARK:
                self._value = max(self._value, value)
            else:
                self._value = value

    def read(self) -> Any:
        if self._getter is not None:
            return self._getter()
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    class _TimerCtx:
        def __init__(self, pvar: "Pvar") -> None:
            self._pvar = pvar

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._pvar.add(time.perf_counter() - self._t0)
            return False

    def timing(self) -> "_TimerCtx":
        assert self.pclass is PvarClass.TIMER
        return Pvar._TimerCtx(self)


class Aggregate(Pvar):
    """count/sum/min/max summary pvar (the MPI_T aggregate class).

    The ``*_locked`` helpers let :class:`Histogram` extend the summary
    under ONE lock acquisition (``self._lock`` is not reentrant).
    """

    def __init__(self, name: str, help: str = "",
                 pclass: PvarClass = PvarClass.AGGREGATE) -> None:
        super().__init__(name, pclass, help)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def _observe_locked(self, v: float) -> None:
        self._count += 1
        self._sum += v
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)

    def _read_locked(self) -> Dict[str, Any]:
        return {
            "count": self._count, "sum": self._sum,
            "min": 0.0 if self._min is None else self._min,
            "max": 0.0 if self._max is None else self._max,
        }

    def _reset_locked(self) -> None:
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._observe_locked(v)

    # generic bump (pvar-agnostic call sites) records an observation
    def add(self, delta: float = 1) -> None:
        self.observe(delta)

    def read(self) -> Dict[str, Any]:
        with self._lock:
            return self._read_locked()

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()


class Histogram(Aggregate):
    """Log2-bucketed distribution pvar (latencies, message sizes).

    ``observe(v)`` files v > 0 under the bucket whose upper bound is
    the smallest power of two >= v (exponent via ``frexp`` — no float
    log rounding at the boundaries); v <= 0 counts under the 0-bound
    bucket. ``read()`` returns the Aggregate summary plus ``buckets``
    mapping each upper bound to its *per-bucket* (non-cumulative)
    count; the Prometheus exporter cumulates at exposition time.
    """

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help, PvarClass.HISTOGRAM)
        self._exp: Dict[int, int] = {}  # e -> count of v in (2^(e-1), 2^e]
        self._zero = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._observe_locked(v)
            if v <= 0:
                self._zero += 1
                return
            m, e = math.frexp(v)  # v = m * 2**e with 0.5 <= m < 1
            if m == 0.5:  # exact power of two belongs to the bucket below
                e -= 1
            self._exp[e] = self._exp.get(e, 0) + 1

    def read(self) -> Dict[str, Any]:
        with self._lock:
            out = self._read_locked()
            buckets: Dict[float, int] = {}
            if self._zero:
                buckets[0.0] = self._zero
            for e in sorted(self._exp):
                buckets[float(2.0 ** e)] = self._exp[e]
            out["buckets"] = buckets
            return out

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()
            self._exp.clear()
            self._zero = 0


class PvarRegistry:
    def __init__(self) -> None:
        self._pvars: Dict[str, Pvar] = {}
        self._lock = threading.Lock()

    def register(self, name: str, pclass: PvarClass = PvarClass.COUNTER,
                 help: str = "", getter: Optional[Callable[[], Any]] = None) -> Pvar:
        with self._lock:
            if name in self._pvars:
                return self._pvars[name]
            if pclass is PvarClass.HISTOGRAM:
                pv: Pvar = Histogram(name, help)
            elif pclass is PvarClass.AGGREGATE:
                pv = Aggregate(name, help)
            else:
                pv = Pvar(name, pclass, help, getter)
            self._pvars[name] = pv
            return pv

    def lookup(self, name: str) -> Optional[Pvar]:
        with self._lock:
            return self._pvars.get(name)

    def read_all(self) -> Dict[str, Any]:
        with self._lock:
            return {n: p.read() for n, p in sorted(self._pvars.items())}

    def describe_all(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {"name": p.name, "class": p.pclass.value, "help": p.help,
                 "value": p.read()}
                for p in sorted(self._pvars.values(), key=lambda p: p.name)
            ]

    def reset_all(self) -> None:
        with self._lock:
            for p in self._pvars.values():
                p.reset()

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._pvars.clear()


PVARS = PvarRegistry()


def counter(name: str, help: str = "") -> Pvar:
    return PVARS.register(name, PvarClass.COUNTER, help)


def timer(name: str, help: str = "") -> Pvar:
    return PVARS.register(name, PvarClass.TIMER, help)


def highwatermark(name: str, help: str = "") -> Pvar:
    return PVARS.register(name, PvarClass.HIGHWATERMARK, help)


def histogram(name: str, help: str = "") -> Histogram:
    pv = PVARS.register(name, PvarClass.HISTOGRAM, help)
    assert isinstance(pv, Histogram), f"{name} registered as {pv.pclass}"
    return pv


def aggregate(name: str, help: str = "") -> Aggregate:
    pv = PVARS.register(name, PvarClass.AGGREGATE, help)
    assert isinstance(pv, Aggregate), f"{name} registered as {pv.pclass}"
    return pv
