"""Native event-ring expansion — the zero-copy datapath's spans.

The native datapath takes Python out of the byte path, which also
takes the byte path out of the trace: fragments crossing
``native/btl_shm.cc`` rings and ``native/btl_tcp.cc`` writev never
touch an emit site, so a merged doctor trace would show the header
handshake and then silence where the bytes moved. This module is the
flight recorder's (``obs/ledger.py``) discipline applied one layer
down: the C transports append one fixed 32-byte record per SGC2
fragment into a per-process mmap'd ring ("ompitpu-nativeev-v1",
cvar-gated, off by default — see ``btl/nativewire.py`` for the
lifecycle), and Python only ever decodes records at dump time.

:func:`expand_record` turns one record into a wire-layer span whose
flow id re-derives from the (tag, xfer, idx) triple already carried
in every SGC2 frame header — the sender and receiver each log their
own side with no coordination, and the ids meet in the doctor's merge
exactly like the hier/ledger flows, keeping cross-rank arrows for
bytes Python never touched.

Timebase: the C side stamps CLOCK_REALTIME nanoseconds (the only
clock two processes on one host share without a handshake); journal
spans use ``perf_counter``. Each dump records this process's
``rt_minus_pc`` bridge (``time.time() - perf_counter()``) so
expansion lands the spans on the journal's timebase, after which the
doctor's per-dump ``clock_offset_s`` correction applies unchanged.
"""

from __future__ import annotations

import json
import time as _time
from typing import Any, Dict, List, Optional

from .. import obs as _obs
from ..mca import pvar as _pvar
from .journal import flow_id

FORMAT = "ompitpu-nativeev-v1"
RECORD_BYTES = 32

_dumps_pvar = _pvar.counter(
    "obs_nativeev_dumps",
    "native event-ring dump documents produced (finalize dumps + "
    "watchdog postmortem drops + explicit tool snapshots)",
)

#: the live per-process event ring (a ``bindings.NativeEventRing``),
#: registered by the nativewire component when the cvar enables it —
#: dump/contributor entry points read through this
_ring = None


def set_ring(ring) -> None:
    """Register the process's live event ring (None detaches)."""
    global _ring
    _ring = ring


def get_ring():
    return _ring


# ---------------------------------------------------------------------------
# snapshot / dump (the ledger dump discipline, one layer down)
# ---------------------------------------------------------------------------

def snapshot(ring=None) -> Dict[str, Any]:
    """The full dump document tpu-doctor expands: decoded records +
    rank identity/clock for the merge + the realtime->perf_counter
    bridge for this process."""
    ring = ring if ring is not None else _ring
    first, recs = (0, []) if ring is None else ring.read()
    total = 0 if ring is None else ring.count()
    doc = {
        "format": FORMAT, "record_bytes": RECORD_BYTES,
        "meta": _obs.rank_identity(),
        "clock_offset_s": _obs.clock_offset(),
        "rt_minus_pc": _time.time() - _time.perf_counter(),
        "first_seq": int(first), "total": int(total),
        "records": recs,
    }
    _dumps_pvar.add()
    if _obs.enabled:
        _obs.record("nativeev_dump", "obs", _time.perf_counter(), 0.0,
                    nbytes=len(recs))
    return doc


def dump(path: str, ring=None) -> str:
    with open(path, "w") as f:
        json.dump(snapshot(ring), f)
    return path


def _nativeev_tail(n: int = 32) -> Dict[str, Any]:
    """Watchdog-postmortem contributor: the newest decoded native
    events (best-effort, never raises past the watchdog's guard)."""
    if _ring is None:
        return {"installed": False}
    first, recs = _ring.read()
    return {"installed": True, "total": int(_ring.count()),
            "first_seq": int(first), "records": recs[-n:]}


# ---------------------------------------------------------------------------
# expansion: records -> synthetic wire-layer spans
# ---------------------------------------------------------------------------

def frag_flow_id(tag: int, xfer: int, idx: int) -> int:
    """The native fragment flow id: both transfer endpoints re-derive
    it independently from the SGC2 triple their own transport logged —
    no coordination, same 64-bit FNV fold as every other flow."""
    return flow_id("nw", tag, xfer, idx)


def expand_record(rec: Dict[str, Any], rt_minus_pc: float = 0.0,
                  seq: int = 0) -> Dict[str, Any]:
    """One decoded event record as a journal-dump wire-layer span.

    Send records become the flow's "s" side, receive records the "t"
    side; ``wait_s`` carries how long the emitting call sat blocked
    (ring full on the producer, ring/queue empty on the consumer) —
    the per-fragment complement of the ring counters' aggregate
    stall_ns."""
    recv = bool(rec.get("recv"))
    t = float(rec["t_ns"]) / 1e9 - rt_minus_pc
    return {
        "seq": int(seq), "op": "nw_frag_recv" if recv else "nw_frag_send",
        "layer": "wire", "t": t, "dt": 0.0,
        "bytes": int(rec.get("bytes", 0)), "peer": -1,
        "comm": -1,
        "flow": frag_flow_id(int(rec["tag"]), int(rec["xfer"]),
                             int(rec["idx"])),
        "fs": "t" if recv else "s",
        "wait_s": float(rec.get("wait_ns", 0)) / 1e9,
        "nativeev": True,
    }


def expand_dump(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """All synthetic spans of one event-ring dump document, time
    order."""
    bridge = float(doc.get("rt_minus_pc", 0.0) or 0.0)
    base = int(doc.get("first_seq", 0) or 0)
    spans = [expand_record(rec, bridge, base + i)
             for i, rec in enumerate(doc.get("records") or [])]
    spans.sort(key=lambda s: s["t"])
    return spans


def _reset_for_tests() -> None:
    global _ring
    _ring = None


from . import watchdog as _watchdog  # noqa: E402  (import order: tail)

_watchdog.add_contributor("nativeev_tail", _nativeev_tail)
