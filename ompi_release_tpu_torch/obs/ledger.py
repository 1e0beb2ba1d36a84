"""Plan-relative flight recorder — compiled fires stay observable
without de-optimizing the hot path.

The compiled steady state (``coll/plan``) used to go dark the moment
obs came on: every observed fire fell back to the interpreted path so
the span/flow record stayed complete, which meant tracing *replaced*
the production path instead of observing it. This module inverts
that. A frozen plan is deterministic — its round structure, peers,
message sizes, and flow-id derivation are all fixed at freeze time —
so the plan registers that structure HERE once, and every compiled
fire appends only one fixed-size binary record into a per-rank slot
ring:

    header  ``<BHiQIIdd``  (39 bytes, little-endian, no padding)
        kind      u8   0 = device (one XLA program), 1 = spanning,
                       2 = rma (one fused epoch program, osc/plan)
        n_rounds  u16  planned wire rounds timed in this fire
        cid       i32  communicator id
        plan_id   u64  ledger plan id (per-rank registry key)
        seq       u32  per-rank posting sequence
        round0    u32  hier round counter at fire time (flow-id base)
        t_start   f64  perf_counter at fire entry
        t_end     f64  perf_counter after the fire
    tail    ``n_rounds`` f64 round-end clock reads (one per planned
            wire round, appended by ``PlannedXchg``)

The fire path is lock-free: the ring cursor and posting sequence are
``itertools.count`` objects (atomic under the GIL) and each slot
holds one immutable ``bytes`` record — no span objects, no dicts, no
header packing beyond one ``struct.pack``.

:func:`expand_record` re-derives full synthetic spans from a record
plus its frozen plan metadata: a per-round hier span, per-message
``hier_send``/``hier_recv`` instants carrying the SAME ``("hier",
cid, round, src, dst, k)`` FNV flow ids ``coll/hier.py`` emits on
the interpreted path (k accumulated per directed pair in posting
order, both sides re-deriving independently), and one ``coll``-layer
span per device fire. ``tpu-doctor`` therefore merges compiled
traffic into Perfetto flow arrows, skew reports, and the sampler's
per-comm ``coll_*`` series exactly like interpreted traffic.

``obs/export.maybe_dump_ledger`` writes the ring next to the journal
dump at finalize; watchdog postmortems drop a ledger dump beside the
postmortem file and carry the decoded tail inline.
"""

from __future__ import annotations

import itertools
import json
import struct
import threading
import time as _time
from typing import Any, Dict, List, Optional, Tuple

from .. import obs as _obs
from ..mca import pvar as _pvar
from ..mca import var as _var
from .journal import flow_id

FORMAT = "ompitpu-ledger-v1"
DEFAULT_SIZE = 16384

KIND_DEVICE = 0
KIND_SPANNING = 1
KIND_RMA = 2

_HDR = struct.Struct("<BHiQIIdd")
_TAILS: Dict[int, struct.Struct] = {}


def register_vars() -> None:
    _var.register(
        "obs_ledger_size", "size", DEFAULT_SIZE,
        "Flight-recorder ring capacity in fixed-size fire records "
        "(oldest records are overwritten); one record per compiled-"
        "plan fire while obs is on",
    )


register_vars()  # idempotent; the cvar must exist before first record

_records = _pvar.counter(
    "ledger_records",
    "compiled-plan fire records appended to the flight-recorder ring "
    "(one fixed-size binary record per observed compiled fire)",
)
_dropped = _pvar.counter(
    "ledger_dropped",
    "flight-recorder records lost to ring wrap (raise obs_ledger_size)",
)

_lock = threading.Lock()  # registration / resize / dump — never fires
#: plan id -> frozen-structure metadata (JSON-able; registered once
#: per freeze, read only at expansion/dump time)
_plans: Dict[int, Dict[str, Any]] = {}
_next_plan = itertools.count(1)
#: the fire path: next(_cursor) and a slot store, nothing else
_ring: List[Optional[bytes]] = [None] * int(
    _var.get("obs_ledger_size", DEFAULT_SIZE))
_cursor = itertools.count()
_seq = itertools.count()


def _tail(n: int) -> struct.Struct:
    s = _TAILS.get(n)
    if s is None:
        s = _TAILS[n] = struct.Struct("<%dd" % n)
    return s


# ---------------------------------------------------------------------------
# plan registration (once per freeze) + the per-fire record
# ---------------------------------------------------------------------------

def _itemsize(dtype: Any) -> int:
    """Bytes per element of a plan's dtype (a torch dtype, a numpy dtype
    or either's name); 0 when unknown."""
    size = getattr(dtype, "itemsize", None)
    if isinstance(size, int):
        return size
    name = str(dtype)
    if name.startswith("torch."):
        name = name[6:]
    if name == "bfloat16":
        return 2
    try:
        import numpy as np

        return int(np.dtype(name).itemsize)
    except TypeError:
        return 0


def _sig_summary(sig: Any) -> str:
    s = str(sig)
    return s if len(s) <= 160 else s[:157] + "..."


def register_device_plan(cid: int, name: str, nbytes: int,
                         sig: Any = "") -> int:
    """Register one frozen device plan (a single compiled XLA
    program); returns its ledger plan id."""
    meta = {"kind": "device", "cid": int(cid), "name": name,
            "nbytes": int(nbytes), "sig": _sig_summary(sig),
            "rounds": []}
    with _lock:
        pid = next(_next_plan)
        _plans[pid] = meta
    return pid


def register_rma_plan(cid: int, name: str, nbytes: int,
                      sig: Any = "") -> int:
    """Register one frozen RMA access plan (a single fused epoch
    program — ``osc/plan``); returns its ledger plan id. Fires expand
    to ``osc``-layer spans, so the doctor's per-comm series see
    compiled RMA epochs exactly like interpreted ``win_apply``
    traffic."""
    meta = {"kind": "rma", "cid": int(cid), "name": name,
            "nbytes": int(nbytes), "sig": _sig_summary(sig),
            "rounds": []}
    with _lock:
        pid = next(_next_plan)
        _plans[pid] = meta
    return pid


def register_spanning_plan(cid: int, name: str, pidx: int,
                           wire_rounds, sig: Any = "") -> int:
    """Register one frozen wire plan's round structure: per round the
    per-peer send sizes (posting order — the k counters advance in
    this order) and receive counts. ``wire_rounds`` is the plan's
    :class:`~..coll.plan.WireRound` list."""
    rounds = []
    for rnd in wire_rounds:
        sends = []
        for p, arrs in rnd.sends_meta:
            sizes = []
            for shape, dtype in arrs:
                n = 1
                for d in shape:
                    n *= int(d)
                sizes.append(n * _itemsize(dtype))
            sends.append([int(p), sizes])
        recvs = [[int(p), int(c)] for p, c in rnd.recvs_t]
        rounds.append({"sends": sends, "recvs": recvs})
    meta = {"kind": "spanning", "cid": int(cid), "name": name,
            "pidx": int(pidx), "sig": _sig_summary(sig),
            "rounds": rounds}
    with _lock:
        pid = next(_next_plan)
        _plans[pid] = meta
    return pid


def record_fire(kind: int, plan_id: int, cid: int, t_start: float,
                t_end: float, round0: int = 0,
                round_ts: Tuple[float, ...] = ()) -> int:
    """Append one fixed-size fire record (THE hot-path entry; callers
    gate on ``_obs.enabled`` themselves). Returns the posting seq."""
    seq = next(_seq) & 0xFFFFFFFF
    n = len(round_ts)
    rec = _HDR.pack(kind, n, cid, plan_id, seq, round0 & 0xFFFFFFFF,
                    t_start, t_end)
    if n:
        rec += _tail(n).pack(*round_ts)
    ring = _ring
    i = next(_cursor)
    if i >= len(ring):
        _dropped.add()  # wrapped: every write now evicts one record
    ring[i % len(ring)] = rec
    _records.add()
    return seq


# ---------------------------------------------------------------------------
# decode / snapshot / dump
# ---------------------------------------------------------------------------

def decode(rec: bytes) -> Dict[str, Any]:
    """One binary record back into its JSON-able form."""
    kind, n, cid, pid, seq, round0, t0, t1 = _HDR.unpack_from(rec)
    return {"kind": int(kind), "cid": int(cid), "plan": int(pid),
            "seq": int(seq), "round0": int(round0),
            "t_start": t0, "t_end": t1,
            "round_ts": list(_tail(n).unpack_from(rec, _HDR.size))
            if n else []}


def records(since_seq: int = -1) -> List[Dict[str, Any]]:
    """Decoded buffered records with seq > ``since_seq``, posting
    order. Wrap-safe for pollers: seq is monotonic per rank."""
    out = [decode(r) for r in list(_ring) if r is not None]
    out.sort(key=lambda d: d["seq"])
    if since_seq >= 0:
        out = [d for d in out if d["seq"] > since_seq]
    return out


def plans() -> Dict[int, Dict[str, Any]]:
    with _lock:
        return {pid: dict(meta) for pid, meta in _plans.items()}


def snapshot() -> Dict[str, Any]:
    """The full dump document tpu-doctor expands: frozen-plan
    metadata + decoded records + rank identity/clock for the merge."""
    recs = records()
    with _lock:
        plan_doc = {str(pid): dict(meta) for pid, meta in _plans.items()}
    doc = {"format": FORMAT, "record_bytes": _HDR.size,
           "meta": _obs.rank_identity(),
           "clock_offset_s": _obs.clock_offset(),
           "plans": plan_doc, "records": recs}
    if _obs.enabled:
        _obs.record("ledger_dump", "obs", _time.perf_counter(), 0.0,
                    nbytes=len(recs))
    return doc


def dump(path: str) -> str:
    with open(path, "w") as f:
        json.dump(snapshot(), f)
    return path


def _ledger_tail(n: int = 32) -> Dict[str, Any]:
    """Watchdog-postmortem contributor: the newest decoded records +
    the plans they reference (best-effort, never raises past the
    watchdog's guard)."""
    recs = records()[-n:]
    want = {r["plan"] for r in recs}
    with _lock:
        plan_doc = {str(pid): dict(meta) for pid, meta in _plans.items()
                    if pid in want}
    return {"records": recs, "plans": plan_doc,
            "total": int(_records.read()),
            "dropped": int(_dropped.read())}


# ---------------------------------------------------------------------------
# expansion: records -> synthetic spans (journal-dump span format)
# ---------------------------------------------------------------------------

def expand_record(rec: Dict[str, Any],
                  plan_docs: Dict[Any, Dict[str, Any]],
                  pidx: int = 0) -> List[Dict[str, Any]]:
    """Synthetic spans for one fire record, in journal-dump form.

    Device fires expand to one ``coll``-layer span (the per-comm
    ``coll_*`` series and round alignment see compiled device traffic
    again); RMA fires to one ``osc``-layer span per epoch replay.
    Spanning fires expand to one hier-layer span per planned
    wire round plus per-message send/recv instants carrying the
    interpreted path's exact flow ids: ``flow_id("hier", cid, round0,
    src, dst, k)`` with k accumulated per directed pair in posting
    order — each rank re-derives its own side, and the ids meet in
    the doctor's merge because the frozen structures are
    complementary by construction."""
    meta = plan_docs.get(str(rec["plan"])) or plan_docs.get(rec["plan"])
    if meta is None:
        return []
    cid = rec["cid"]
    name = meta.get("name", "coll")
    if meta.get("kind") in ("device", "rma") or not meta.get("rounds"):
        layer = "osc" if meta.get("kind") == "rma" else "coll"
        return [{"seq": rec["seq"], "op": name, "layer": layer,
                 "t": rec["t_start"],
                 "dt": max(0.0, rec["t_end"] - rec["t_start"]),
                 "bytes": int(meta.get("nbytes", 0)), "peer": -1,
                 "comm": cid, "ledger": True}]
    me = int(meta.get("pidx", pidx))
    round0 = rec["round0"]
    ts = rec.get("round_ts") or []
    spans: List[Dict[str, Any]] = []
    k: Dict[Tuple[int, int], int] = {}
    t_prev = rec["t_start"]
    for r, rmeta in enumerate(meta["rounds"]):
        t_end_r = ts[r] if r < len(ts) else rec["t_end"]
        spans.append({
            "seq": rec["seq"], "op": f"{name}_wire_round{r}",
            "layer": "hier", "t": t_prev,
            "dt": max(0.0, t_end_r - t_prev),
            "bytes": sum(int(b) for _, sizes in rmeta["sends"]
                         for b in sizes),
            "peer": -1, "comm": cid, "ledger": True})
        for p, sizes in rmeta["sends"]:
            for nb in sizes:
                kk = k.get((me, p), 0)
                k[(me, p)] = kk + 1
                spans.append({
                    "seq": rec["seq"], "op": "hier_send",
                    "layer": "hier", "t": t_prev, "dt": 0.0,
                    "bytes": int(nb), "peer": int(p), "comm": cid,
                    "flow": flow_id("hier", cid, round0, me, p, kk),
                    "fs": "s", "ledger": True})
        for p, cnt in rmeta["recvs"]:
            for _ in range(int(cnt)):
                kk = k.get((p, me), 0)
                k[(p, me)] = kk + 1
                spans.append({
                    "seq": rec["seq"], "op": "hier_recv",
                    "layer": "hier", "t": t_end_r, "dt": 0.0,
                    "bytes": 0, "peer": int(p), "comm": cid,
                    "flow": flow_id("hier", cid, round0, p, me, kk),
                    "fs": "t", "ledger": True})
        t_prev = t_end_r
    return spans


def expand_dump(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """All synthetic spans of one ledger dump document, time order."""
    plan_docs = doc.get("plans") or {}
    pidx = int((doc.get("meta") or {}).get("pidx", 0))
    spans: List[Dict[str, Any]] = []
    for rec in doc.get("records") or []:
        spans.extend(expand_record(rec, plan_docs, pidx))
    spans.sort(key=lambda s: s["t"])
    return spans


# ---------------------------------------------------------------------------
# housekeeping
# ---------------------------------------------------------------------------

def resize(size: int) -> None:
    """Change ring capacity, keeping the newest records."""
    global _ring, _cursor
    with _lock:
        recs = sorted((decode(r)["seq"], r) for r in _ring
                      if r is not None)
        size = max(1, int(size))
        newest = recs[-size:]
        _ring = [None] * size
        for i, (_, r) in enumerate(newest):
            _ring[i] = r
        _cursor = itertools.count(len(newest))


def _reset_for_tests() -> None:
    global _ring, _cursor, _seq, _next_plan
    with _lock:
        _plans.clear()
        _ring = [None] * int(_var.get("obs_ledger_size", DEFAULT_SIZE))
        _cursor = itertools.count()
        _seq = itertools.count()
        _next_plan = itertools.count(1)


from . import watchdog as _watchdog  # noqa: E402  (import order: tail)

_watchdog.add_contributor("ledger_tail", _ledger_tail)
