"""Ring-buffer event journal — the observability plane's spine.

A fixed-size, lock-protected ring of :class:`Span` records ``(op,
layer, t_start, dt, nbytes, peer, comm_id, seq)`` written by emit
points inside the framework (coll driver, vcoll edge, pml, btl,
request wait, sharded IO, peruse bridge, PMPI tracer). Oldest spans
are overwritten; ``seq`` is process-monotonic so exporters and tools
can detect wrap/loss. Recording never allocates beyond the span
object and never blocks on IO — exporters (``obs/export.py``) read a
snapshot and format offline.

Timestamps are ``time.perf_counter()`` seconds. For XLA-dispatched
work ``dt`` is *dispatch-side* time (jax dispatch is async; blocking
for device completion inside an emit point would change program
behavior); peruse-bridge spans carry the event's element count in the
``nbytes`` slot, as fired.

**Cross-rank flow context**: a span may carry a ``flow`` id plus a
``flow_side`` ("s" = this span produced the message, "t" = this span
consumed it). Both sides derive the SAME id from identifiers that
already cross the wire (the p2p envelope's (sender process, seq), the
hier round's (cid, round, pair, msg index), the window service's
(origin process, token)) — no wire-format change, and ``tpu-doctor``
joins per-rank journals into Perfetto flow arrows by matching ids.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

DEFAULT_SIZE = 4096

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3


def flow_id(*parts) -> int:
    """Deterministic 64-bit flow id from identifying parts (FNV-1a over
    their joined string form). Python's ``hash()`` is salted per
    process (PYTHONHASHSEED), so two ranks hashing the same tuple would
    NOT agree — this must stay an explicit, process-independent fold.
    Never returns 0 (0 = "no flow" in a span)."""
    h = _FNV_OFFSET
    for b in "\x1f".join(str(p) for p in parts).encode():
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h or 1


class Span:
    __slots__ = ("seq", "op", "layer", "t_start", "dt", "nbytes",
                 "peer", "comm_id", "flow", "flow_side")

    def __init__(self, seq: int, op: str, layer: str, t_start: float,
                 dt: float, nbytes: int = 0, peer: int = -1,
                 comm_id: int = -1, flow: int = 0,
                 flow_side: str = "") -> None:
        self.seq = seq
        self.op = op
        self.layer = layer
        self.t_start = t_start
        self.dt = dt
        self.nbytes = nbytes
        self.peer = peer
        self.comm_id = comm_id
        self.flow = flow
        self.flow_side = flow_side

    def asdict(self) -> Dict[str, Any]:
        d = {"seq": self.seq, "op": self.op, "layer": self.layer,
             "t": self.t_start, "dt": self.dt, "bytes": self.nbytes,
             "peer": self.peer, "comm": self.comm_id}
        if self.flow:
            d["flow"] = self.flow
            d["fs"] = self.flow_side
        return d

    def __repr__(self) -> str:
        return (f"Span(#{self.seq} {self.layer}/{self.op} "
                f"dt={self.dt:.3e}s bytes={self.nbytes})")


class Journal:
    def __init__(self, size: int = DEFAULT_SIZE) -> None:
        self._lock = threading.Lock()
        self._size = max(1, int(size))
        self._buf: List[Optional[Span]] = [None] * self._size
        self._next_seq = 0
        self._wrapped = 0  # spans overwritten or squeezed out by resize

    @property
    def size(self) -> int:
        return self._size

    @property
    def total_recorded(self) -> int:
        """Spans ever recorded (monotonic across wraps and clears)."""
        with self._lock:
            return self._next_seq

    @property
    def dropped(self) -> int:
        """Spans lost to CAPACITY — ring wrap or a shrinking resize.
        Spans removed by an explicit clear() are not losses and do not
        count (the obs_journal_dropped pvar tells operators to raise
        obs_journal_size; clear() must not trigger that advice)."""
        with self._lock:
            return self._wrapped

    def record(self, op: str, layer: str, t_start: float, dt: float,
               nbytes: int = 0, peer: int = -1, comm_id: int = -1,
               flow: int = 0, flow_side: str = "") -> Span:
        with self._lock:
            seq = self._next_seq
            self._next_seq = seq + 1
            sp = Span(seq, op, layer, t_start, dt, nbytes, peer, comm_id,
                      flow, flow_side)
            slot = seq % self._size
            if self._buf[slot] is not None:
                self._wrapped += 1
            self._buf[slot] = sp
            return sp

    def _snapshot_locked(self) -> List[Span]:
        spans = [s for s in self._buf if s is not None]
        spans.sort(key=lambda s: s.seq)
        return spans

    def snapshot(self) -> List[Span]:
        """Buffered spans, oldest first."""
        with self._lock:
            return self._snapshot_locked()

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for s in self._buf if s is not None)

    def clear(self) -> None:
        """Drop buffered spans; seq keeps counting (monotonic)."""
        with self._lock:
            self._buf = [None] * self._size

    def resize(self, size: int) -> None:
        """Change capacity in place, keeping the newest spans."""
        with self._lock:
            spans = self._snapshot_locked()
            keep = spans[-max(1, int(size)):]
            self._wrapped += len(spans) - len(keep)  # squeezed out
            self._size = max(1, int(size))
            self._buf = [None] * self._size
            for sp in keep:
                self._buf[sp.seq % self._size] = sp


#: process-global journal every emit point writes into
JOURNAL = Journal()
