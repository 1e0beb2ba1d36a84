"""Continuous pvar time-series sampler — the fleet metrics plane's
per-process source.

PRs 1 and 4 built the *event* side (span journal, flow ids,
postmortems); pvars were still read only at snapshot points (bench
labels, ``tpu_top --metrics`` polling one server page). This module is
the *continuous* side: a gated background thread takes periodic
**delta** snapshots of every registered pvar (COUNTER/TIMER deltas,
AGGREGATE/HISTOGRAM element-wise deltas — the MPI_T session-delta
semantic from ``mca/mpit.py``) into a bounded ring of
:class:`SeriesPoint`-shaped dicts, each stamped with the sample time
and a **communicator scope** (cid) so future multi-tenant consumers
(ROADMAP item 4) get isolated series per tenant:

- process-wide pvar deltas carry ``cid == -1`` (the process scope);
- journal-derived collective series (``coll_ops`` / ``coll_bytes`` /
  ``coll_seconds`` per communicator, folded from the spans recorded
  since the previous tick) carry the real cid.

Arm/disarm rides ``Runtime.init``/``finalize`` behind the
``obs_sample_interval`` cvar (0 = off). Cost discipline is the plane's
one-attribute-check contract: when off, NOTHING runs — no thread, no
clock reads — and every emit site in this file is gated on
``_obs.enabled`` (enforced by ``tests/test_obs_gating.py``'s AST scan,
run over the port by ``tests/test_torch_obs_plane.py``). When on, each
tick's cost is accounted in the ``obs_sample_overhead_seconds`` pvar so
the overhead claim is *measured*, not asserted; ``obs_series_points``
counts every point ever recorded (ring wraps included).

When the process runs under tpurun, each tick also **pushes** the new
points to the HNP over the coordinator's TAG_SERIES channel (gated by
``obs_sample_push``), giving the job one fleet-wide store that ``tpu-doctor`` merges
offline and ``tpu_top --fleet`` renders live.

The pvar scan is registry-driven, so counters that live OUTSIDE
Python fold in with no sampler change: ``btl/nativewire.py`` exposes
the C-side ring/endpoint telemetry blocks (``wire_native_bytes``
deltas split native-vs-staged throughput in ``tpu_top``;
``wire_native_ring_stalls`` / ``wire_native_stall_seconds`` /
``wire_native_ring_hwm_frac`` are the backpressure series) as getter
pvars that read shared memory on each tick — the native byte path
itself never executes a Python emit site.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..mca import pvar as _pvar
from ..mca import var as _var
from .. import obs as _obs

DEFAULT_RING = 4096
#: pushes failing this many consecutive times stop trying (the HNP is
#: gone or never existed; local ring + finalize dump still work)
PUSH_FAIL_LIMIT = 5

_points_total = _pvar.counter(
    "obs_series_points",
    "time-series points ever recorded by the continuous pvar sampler "
    "(ring wraps included)",
)
_overhead = _pvar.timer(
    "obs_sample_overhead_seconds",
    "accumulated seconds the background sampler spent taking delta "
    "snapshots (the measured cost of the continuous metrics plane)",
)
_ticks = _pvar.counter(
    "obs_sample_ticks", "sampler ticks taken since process start",
)

#: observability-of-observability pvars are excluded from the delta
#: scan: the sampler's own counters change on every tick by
#: construction, and the journal bookkeeping moves whenever the
#: sampler records its own tick span — sampling either means no tick
#: is ever quiet, so an idle fleet would push self-observation frames
#: forever and slowly evict real data from the ring. All stay
#: readable through the pvar snapshot / metrics RPC.
_SELF_PVARS = frozenset((
    "obs_sample_ticks", "obs_series_points",
    "obs_sample_overhead_seconds",
    "obs_journal_events", "obs_journal_dropped",
))


def register_vars() -> None:
    _var.register(
        "obs_sample_interval", "float", 0.0,
        "Seconds between continuous pvar delta snapshots (the fleet "
        "metrics plane's sampling period); 0 = sampler off — no "
        "thread, no clock reads (needs the obs plane enabled)",
    )
    _var.register(
        "obs_sample_ring", "int", DEFAULT_RING,
        "Bounded time-series ring capacity in points (oldest points "
        "are overwritten); applied when the sampler starts",
    )
    _var.register(
        "obs_sample_push", "bool", True,
        "Push each tick's new series points to the HNP over "
        "TAG_SERIES when running under tpurun (the fleet aggregation "
        "tpu_top --fleet renders); local ring + finalize dump work "
        "either way",
    )


register_vars()  # idempotent; cvars must exist before any start()


# ---------------------------------------------------------------------------
# histogram percentile math (log2 buckets -> quantile estimate)
# ---------------------------------------------------------------------------


def percentile(buckets: Dict[Any, float], q: float) -> Optional[float]:
    """Quantile estimate from a log2-bucketed histogram ``{upper_bound:
    count}`` (the :class:`mca.pvar.Histogram` read/delta form, JSON
    string keys tolerated). Returns the geometric midpoint of the
    bucket holding the q-quantile observation — the best unbiased
    point estimate when only the bucket is known — or the bound itself
    for the 0-bucket. None when the histogram is empty."""
    if not buckets:
        return None
    items = sorted(((float(k), float(v)) for k, v in buckets.items()
                    if float(v) > 0), key=lambda kv: kv[0])
    total = sum(v for _, v in items)
    if total <= 0:
        return None
    target = max(1.0, q * total)
    cum = 0.0
    for ub, count in items:
        cum += count
        if cum >= target:
            if ub <= 0:
                return 0.0
            # log2 buckets: the bucket spans (ub/2, ub]
            return (ub / 2.0 + ub) / 2.0
    return items[-1][0]


# ---------------------------------------------------------------------------
# delta math (shared shape with mpit's session deltas)
# ---------------------------------------------------------------------------


def _delta(cur: Any, base: Any) -> Any:
    """Delta of one pvar read against the previous tick's read.
    Scalars subtract; dict reads (AGGREGATE/HISTOGRAM) subtract
    elementwise with extrema passing through (not invertible over a
    window) — the ``mca/mpit.py`` session-delta rule."""
    if isinstance(cur, dict):
        bd = base if isinstance(base, dict) else {}
        return {k: (v if k in ("min", "max")
                    else _delta(v, bd.get(k, 0)))
                for k, v in cur.items()}
    if isinstance(cur, (int, float)) and isinstance(base, (int, float)):
        return float(cur) - float(base)
    return cur


def _is_zero(v: Any) -> bool:
    if isinstance(v, dict):
        return all(_is_zero(x) for k, x in v.items()
                   if k not in ("min", "max"))
    if isinstance(v, (int, float)):
        return float(v) == 0.0
    return False


# ---------------------------------------------------------------------------
# the bounded series ring
# ---------------------------------------------------------------------------


class SeriesRing:
    """Bounded ring of time-series points. A point is a plain dict
    ``{"i": monotonic index, "t": perf_counter seconds, "cid": scope,
    "name": series name, "v": float | dict delta}`` — JSON-able as-is,
    so exporters and the push path never reshape it."""

    def __init__(self, size: int = DEFAULT_RING) -> None:
        self._lock = threading.Lock()
        self._size = max(1, int(size))
        self._buf: deque = deque(maxlen=self._size)
        self._next_i = 0

    @property
    def size(self) -> int:
        return self._size

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._next_i

    def append(self, t: float, cid: int, name: str, value: Any,
               tenant: int = -1) -> None:
        with self._lock:
            pt = {"i": self._next_i, "t": t, "cid": cid,
                  "name": name, "v": value}
            if tenant >= 0:
                # the multi-tenant dimension (service plane): points
                # whose cid falls in a tenant band carry the tenant
                # id, so fleet/daemon consumers can aggregate "who is
                # burning the fabric" without re-deriving band math
                pt["tenant"] = tenant
            self._buf.append(pt)
            self._next_i += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        """Buffered points, oldest first."""
        with self._lock:
            return list(self._buf)

    def drain_since(self, cursor: int) -> Tuple[List[Dict[str, Any]], int]:
        """Points with index >= cursor plus the new cursor — the push
        path's incremental read (points are never removed here; the
        ring itself bounds memory)."""
        with self._lock:
            pts = [p for p in self._buf if p["i"] >= cursor]
            return pts, self._next_i

    def resize(self, size: int) -> None:
        with self._lock:
            self._size = max(1, int(size))
            self._buf = deque(self._buf, maxlen=self._size)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


#: process-global ring (identity stable across start/stop cycles so
#: the tpu_server series RPC and finalize dump read one store)
RING = SeriesRing()

#: post-tick hooks, invoked (no arguments) after every delta snapshot
#: — the online re-tuner (:mod:`..tuning.retune`) registers here when
#: armed. Empty by default: one tuple() per tick when nothing consumes
#: the plane, and a raising hook never kills the sampler.
TICK_HOOKS: List[Callable[[], None]] = []


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


class Sampler:
    def __init__(self, ring: SeriesRing = RING) -> None:
        self.ring = ring
        self._prev: Dict[str, Any] = {}
        self._last_seq = 0   # journal cursor for per-cid folding
        self._ledger_seq = -1  # flight-recorder cursor (same folding)
        self._push_cursor = 0
        self._push_failures = 0
        self._agent = None   # tpurun WorkerAgent (fleet push target)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._armed = False  # ever started — stop()'s final tick gate

    # -- one tick ----------------------------------------------------------
    def sample_once(self) -> int:
        """Take one delta snapshot; returns the number of points
        recorded. Safe to call without the thread (selftest, tests,
        final flush)."""
        if not _obs.enabled:
            return 0
        t0 = time.perf_counter()
        n = 0
        # 1. pvar deltas (process scope, cid = -1)
        cur = _pvar.PVARS.read_all()
        for name, value in cur.items():
            if name in _SELF_PVARS:
                continue  # self-observation feedback loop (see above)
            if not isinstance(value, (int, float, dict)):
                continue  # non-numeric getter pvar: not a series
            d = _delta(value, self._prev.get(name, 0))
            if name in self._prev and _is_zero(d):
                continue  # quiet series: no point, no ring churn
            self.ring.append(t0, -1, name, d)
            n += 1
        self._prev = cur
        # 2. journal-derived per-communicator series: fold the spans
        # recorded since the previous tick into per-cid rate points —
        # the scope future tenants are isolated by
        by_cid: Dict[int, List[float]] = {}
        for s in _obs.journal.snapshot():
            if s.seq < self._last_seq or s.layer != "coll":
                continue
            acc = by_cid.setdefault(s.comm_id, [0.0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += float(s.nbytes)
            acc[2] += float(s.dt)
        self._last_seq = _obs.journal.total_recorded
        # 2b. flight-recorder fold: compiled DEVICE fires never touch
        # the journal (one fixed-size binary ledger record each), so
        # their per-cid series fold from the ledger's delta since the
        # last tick. Spanning compiled fires already stamp one
        # coll-layer journal span per round (hier's _round_end runs
        # under planned replay too), so only device records fold here
        # — the series never double count.
        from . import ledger as _ledger

        new_recs = _ledger.records(self._ledger_seq)
        if new_recs:
            plan_meta = _ledger.plans()
            for r in new_recs:
                if r["kind"] == _ledger.KIND_DEVICE:
                    acc = by_cid.setdefault(r["cid"], [0.0, 0.0, 0.0])
                    acc[0] += 1
                    acc[1] += float((plan_meta.get(r["plan"]) or {})
                                    .get("nbytes", 0))
                    acc[2] += max(0.0, r["t_end"] - r["t_start"])
            self._ledger_seq = new_recs[-1]["seq"]
        if by_cid:
            from ..ft.ulfm import tenant_of_cid  # import-light
        for cid, (ops, nbytes, secs) in sorted(by_cid.items()):
            tid = tenant_of_cid(cid)
            self.ring.append(t0, cid, "coll_ops", ops, tenant=tid)
            self.ring.append(t0, cid, "coll_bytes", nbytes, tenant=tid)
            self.ring.append(t0, cid, "coll_seconds", secs, tenant=tid)
            n += 3
        dt = time.perf_counter() - t0
        _ticks.add(1)
        _points_total.add(n)
        _overhead.add(dt)
        # the tick's own journal span only when something was seen: an
        # idle tick must leave NO trace anywhere, or idleness detection
        # (quiet-series skip, empty push) can never converge
        if _obs.enabled and n:
            _obs.record("sample", "obs", t0, dt, nbytes=n)
        for hook in tuple(TICK_HOOKS):
            try:
                hook()
            except Exception:
                pass  # a broken consumer must not kill the plane
        return n

    # -- fleet push --------------------------------------------------------
    def push(self) -> bool:
        """Send the points recorded since the last push to the HNP.
        Returns True when something was sent. Failures back off and
        eventually stop trying (the local ring and finalize dump do
        not depend on the HNP)."""
        agent = self._agent
        if agent is None or self._push_failures >= PUSH_FAIL_LIMIT:
            return False
        pts, cursor = self.ring.drain_since(self._push_cursor)
        if not pts:
            return False
        try:
            agent.push_series(pts, offset_s=_obs.clock_offset(),
                              meta=_obs.rank_identity())
            self._push_cursor = cursor
            self._push_failures = 0
            return True
        except Exception:
            self._push_failures += 1
            return False

    # -- lifecycle ---------------------------------------------------------
    def _loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            if not _obs.enabled:
                continue  # obs flipped off mid-run: idle, don't emit
            try:
                self.sample_once()
                if bool(_var.get("obs_sample_push", True)):
                    self.push()
            except Exception:
                # one bad tick (a getter pvar raising, a torn-down
                # agent) must not kill the plane for the process
                continue

    def start(self, interval: float, runtime=None) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self.ring.resize(int(_var.get("obs_sample_ring", DEFAULT_RING)))
        self._agent = getattr(runtime, "agent", None)
        self._armed = True
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(max(0.01, float(interval)),),
            daemon=True, name="obs-sampler")
        self._thread.start()

    def stop(self, final_push: bool = True) -> None:
        """Disarm: one last delta snapshot (so the finalize dump holds
        the tail of the run), one last push over the still-live HNP
        link, then retire the thread. A sampler that was never armed
        stays inert — a bare obs-enabled finalize must not suddenly
        grow a series ring."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None
        if _obs.enabled and self._armed:
            try:
                self.sample_once()
                if final_push and bool(_var.get("obs_sample_push", True)):
                    self.push()
            except Exception:
                pass
        self._armed = False
        self._agent = None

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


#: process-global sampler (Runtime.init arms it, finalize disarms)
SAMPLER = Sampler()


def maybe_start(runtime=None) -> bool:
    """Runtime.init hook: arm the sampler iff obs is enabled AND
    ``obs_sample_interval`` > 0. Zero-cost when off — the caller's
    ``_obs.enabled`` gate plus this interval check are all that runs."""
    if not _obs.enabled:
        return False
    interval = float(_var.get("obs_sample_interval", 0.0) or 0.0)
    if interval <= 0:
        return False
    SAMPLER.start(interval, runtime=runtime)
    return True


def stop(final_push: bool = True) -> None:
    SAMPLER.stop(final_push=final_push)


def snapshot() -> List[Dict[str, Any]]:
    return RING.snapshot()


def _reset_for_tests() -> None:
    del TICK_HOOKS[:]
    SAMPLER._stop.set()
    t = SAMPLER._thread
    if t is not None:
        t.join(timeout=2)
    SAMPLER._thread = None
    SAMPLER._agent = None
    SAMPLER._armed = False
    SAMPLER._prev = {}
    SAMPLER._last_seq = 0
    SAMPLER._ledger_seq = -1
    SAMPLER._push_cursor = 0
    SAMPLER._push_failures = 0
    RING.clear()
