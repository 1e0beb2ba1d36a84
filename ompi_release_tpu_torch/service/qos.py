"""QoS classes for the multi-tenant wire — lane partitioning +
weighted-fair frame scheduling.

The wire has per-(destination, tag-class) lanes so independent
tags stop serializing behind one stream; under the service plane the
contention unit is the *tenant*, not the tag: a bulk tenant streaming
256 MiB allgather fragments must not head-of-line-block a latency
tenant's 4 KiB allreduce. Two mechanisms, both keyed by the
``wire_qos_classes`` cvar (``"latency:8,bulk:2,best_effort:1"`` —
ordered ``name:weight`` entries):

- **lane classes** (:func:`lane_ranges`): the ``wire_p2p_lanes`` lane
  space is partitioned into per-class contiguous sub-ranges sized by
  weight (largest-remainder, one lane minimum), so one class's p2p
  transfers never share a channel lock with another class's;
- **weighted-fair fragment scheduling** (:class:`WireArbiter`): a
  virtual-clock deficit gate over the fragment bursts of
  ``coll_send_all`` / ``coll_send_planned`` — each class accumulates
  normalized spend (frames / weight), and a class ahead of every
  other *active* class by more than one quantum parks until the
  others catch up or leave. With a single active class the gate is
  one lock acquire + compare: the solo-tenant fast path stays flat.

A sender's class resolves per communicator: the comm's stamped
``_qos_class`` (tenant comms, see :meth:`~..comm.communicator
.Communicator.set_qos_class`) wins over the process-wide
``wire_qos_class`` cvar. Unknown/empty classes ride the legacy full
lane range at weight 1. With ``wire_qos_classes`` unset nothing here
is ever imported by the wire — the zero-config path is byte-for-byte
the single-tenant wire.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from .. import obs as _obs
from ..mca import pvar as _pvar
from ..mca import var as _var
from ..utils.errors import ErrorCode, MPIError

#: frames a class may run ahead of the slowest active class before
#: its gate parks (the DRR quantum — small enough that a latency
#: burst preempts within one pipeline window, large enough that the
#: gate never thrashes on single-fragment rounds)
DEFAULT_QUANTUM = 16.0

_gate_waits = _pvar.counter(
    "wire_qos_gate_waits",
    "fragment bursts the weighted-fair QoS arbiter parked because "
    "their class was ahead of other active classes' fair share",
)
_gate_wait_s = _pvar.timer(
    "wire_qos_gate_wait_seconds",
    "seconds senders spent parked in the QoS arbiter's weighted-fair "
    "gate (the bulk tenant paying for the latency tenant's share)",
)


def register_vars() -> None:
    _var.register(
        "wire_qos_classes", "str", "",
        "Ordered QoS class spec 'name:weight,...' (e.g. "
        "'latency:8,bulk:2,best_effort:1'): partitions the "
        "wire_p2p_lanes lane space per class and arms weighted-fair "
        "scheduling of collective fragment bursts. Empty = off (the "
        "single-tenant legacy wire, zero added cost)",
    )
    _var.register(
        "wire_qos_class", "str", "",
        "This process's default QoS class (a tenant job sets it at "
        "admission); a communicator's stamped class overrides it. "
        "Unknown/empty classes ride the legacy full lane range",
    )


register_vars()  # idempotent; cvars must exist before the first router


def parse_classes(spec: str) -> Dict[str, float]:
    """``"latency:8,bulk:2"`` -> ordered ``{name: weight}``. A bare
    name gets weight 1; malformed weights raise loudly (a typo'd QoS
    config silently collapsing to FIFO would defeat the whole plane)."""
    out: Dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        name = name.strip()
        if not name:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"wire_qos_classes entry {part!r} has no "
                           "class name")
        try:
            weight = float(w) if w.strip() else 1.0
        except ValueError:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"wire_qos_classes weight {w!r} for class "
                           f"'{name}' is not a number")
        if weight <= 0:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"wire_qos_classes weight {weight} for "
                           f"class '{name}' must be > 0")
        out[name] = weight
    return out


def fair_share(cls: str, classes: Dict[str, float]) -> float:
    """``cls``'s guaranteed fraction of the wire under contention
    from every other class — the bound the isolation tests and the
    fleet-sim contention model key on."""
    total = sum(classes.values())
    if total <= 0 or cls not in classes:
        return 1.0
    return classes[cls] / total


def lane_ranges(classes: Dict[str, float],
                nlanes: int) -> Dict[str, Tuple[int, int]]:
    """Partition ``nlanes`` p2p lanes into per-class contiguous
    ``(start, count)`` sub-ranges, weight-proportional by largest
    remainder with a one-lane minimum. More classes than lanes:
    class i shares lane ``i % nlanes`` (count 1) — degraded but never
    starved."""
    names = list(classes)
    n = max(1, int(nlanes))
    if not names:
        return {}
    if len(names) > n:
        return {name: (i % n, 1) for i, name in enumerate(names)}
    total = sum(classes.values())
    exact = {name: classes[name] / total * n for name in names}
    counts = {name: max(1, int(exact[name])) for name in names}
    # largest-remainder distribution of the leftover lanes
    left = n - sum(counts.values())
    by_rem = sorted(names, key=lambda m: (exact[m] - int(exact[m]),
                                          classes[m]), reverse=True)
    i = 0
    while left > 0:
        counts[by_rem[i % len(by_rem)]] += 1
        left -= 1
        i += 1
    while left < 0:  # one-lane minimums overshot: shave the largest
        big = max(names, key=lambda m: counts[m])
        if counts[big] <= 1:  # pragma: no cover - len(names) <= n
            break
        counts[big] -= 1
        left += 1
    out: Dict[str, Tuple[int, int]] = {}
    start = 0
    for name in names:
        out[name] = (start, counts[name])
        start += counts[name]
    return out


class WireArbiter:
    """Weighted-fair virtual-clock gate over concurrent wire senders.

    Every class carries a normalized spend ``vt = frames / weight``.
    :meth:`gate` (called once per fragment burst) parks while this
    class's vt exceeds the minimum vt among the OTHER active classes
    by more than ``quantum / weight`` — so at steady contention the
    per-class frame throughput converges to the weight ratio, while a
    class alone on the wire never waits. A class entering from idle
    catches its clock up to the active minimum (no credit banked for
    idle time — the classic virtual-clock rule). Waits are bounded
    slices so a stalled peer class can only slow, never wedge, the
    gate."""

    def __init__(self, classes: Dict[str, float],
                 quantum: float = DEFAULT_QUANTUM) -> None:
        self._w = {str(k): max(float(v), 1e-9)
                   for k, v in classes.items()}
        self._quantum = float(quantum)
        self._cond = threading.Condition()
        self._active: Dict[str, int] = {}
        self._vt: Dict[str, float] = {}

    def weight(self, cls: Optional[str]) -> float:
        return self._w.get(cls or "", 1.0)

    def _min_other_vt(self, cls: str) -> Optional[float]:
        others = [self._vt.get(c, 0.0) for c, n in self._active.items()
                  if n > 0 and c != cls]
        return min(others) if others else None

    def enter(self, cls: Optional[str]) -> None:
        cls = cls or ""
        with self._cond:
            if self._active.get(cls, 0) == 0:
                floor = self._min_other_vt(cls)
                if floor is not None:
                    self._vt[cls] = max(self._vt.get(cls, 0.0), floor)
            self._active[cls] = self._active.get(cls, 0) + 1

    def leave(self, cls: Optional[str]) -> None:
        cls = cls or ""
        with self._cond:
            n = self._active.get(cls, 1) - 1
            if n <= 0:
                self._active.pop(cls, None)
            else:
                self._active[cls] = n
            self._cond.notify_all()

    def gate(self, cls: Optional[str], cost: float = 1.0) -> None:
        cls = cls or ""
        slack = self._quantum / self.weight(cls)
        with self._cond:
            waited = False
            t0 = 0.0
            while True:
                floor = self._min_other_vt(cls)
                if floor is None or \
                        self._vt.get(cls, 0.0) <= floor + slack:
                    break
                if not waited:
                    waited = True
                    t0 = time.perf_counter()
                    _gate_waits.add()
                self._cond.wait(timeout=0.05)
            self._vt[cls] = (self._vt.get(cls, 0.0)
                             + float(cost) / self.weight(cls))
            if waited:
                dt = time.perf_counter() - t0
                _gate_wait_s.add(dt)
                if _obs.enabled:
                    # the HOL wait this class paid for the others'
                    # fair share — visible in traces per burst
                    _obs.record(f"qos_gate_wait:{cls or '-'}", "wire",
                                t0, dt, nbytes=int(cost))
            self._cond.notify_all()

    def spend(self, cls: Optional[str]) -> float:
        """Normalized spend (test/monitoring hook)."""
        with self._cond:
            return self._vt.get(cls or "", 0.0)


#: one arbiter per class spec: every WireTuning generation sharing a
#: spec shares one arbiter, so fairness state survives cvar-generation
#: churn on unrelated cvars
_arbiters: Dict[str, WireArbiter] = {}
_arbiters_lock = threading.Lock()


def arbiter_for(spec: str) -> WireArbiter:
    with _arbiters_lock:
        arb = _arbiters.get(spec)
        if arb is None:
            arb = _arbiters[spec] = WireArbiter(parse_classes(spec))
        return arb


def _reset_for_tests() -> None:
    with _arbiters_lock:
        _arbiters.clear()
