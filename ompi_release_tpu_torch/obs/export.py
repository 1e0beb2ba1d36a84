"""Exporters — journal and pvars in standard tool formats.

Three consumers, three formats, one data source:

  - :func:`chrome_trace` / :func:`dump_chrome_trace`: Chrome/Perfetto
    ``trace_event`` JSON (load in chrome://tracing or ui.perfetto.dev).
    One pseudo-thread per layer (named via ``thread_name`` metadata
    events); spans with dt > 0 are complete events ("X"), instant
    emit points are thread-scoped instants ("i").
  - :func:`dump_jsonl`: one JSON object per span (the tracer sink's
    line format), for ad-hoc grep/pandas analysis.
  - :func:`prometheus_text`: text exposition of every registered pvar
    (``ompitpu_<name>``), served by the ``tpu_server`` metrics RPC and
    rendered live by ``tpu_top --metrics``. HISTOGRAM pvars become
    real Prometheus histograms (cumulative ``_bucket{le=...}`` +
    ``_sum``/``_count``), AGGREGATE pvars a gauge family.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Sequence

from ..mca import pvar as _pvar
from .journal import JOURNAL as _JOURNAL
from .journal import Span

# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event
# ---------------------------------------------------------------------------


def span_event(s: Dict[str, Any], pid: int, tid: int,
               ts_s: Optional[float] = None) -> Dict[str, Any]:
    """One journal span (``Span.asdict`` form) as a Chrome
    ``trace_event`` — THE conversion shared by the single-rank
    :func:`chrome_trace` and tpu-doctor's multi-rank merge, so the two
    trace shapes cannot drift. ``ts_s`` overrides the span's own
    timestamp (the merge passes clock-offset-corrected seconds)."""
    args = {"bytes": s.get("bytes", 0), "peer": s.get("peer", -1),
            "comm": s.get("comm", -1), "seq": s.get("seq", -1)}
    if s.get("flow"):
        args["flow"] = s["flow"]
        args["flow_side"] = s.get("fs", "")
    if s.get("name"):
        args["range"] = s["name"]  # the mpi.* profiler range's name
    ev: Dict[str, Any] = {
        "name": s["op"], "cat": s["layer"], "pid": pid, "tid": tid,
        # trace_event wants microseconds
        "ts": (s["t"] if ts_s is None else ts_s) * 1e6,
        "args": args,
    }
    if s["dt"] > 0:
        ev["ph"] = "X"
        ev["dur"] = s["dt"] * 1e6
    else:
        ev["ph"] = "i"
        ev["s"] = "t"  # thread-scoped instant
    return ev


def chrome_trace(spans: Optional[Sequence[Span]] = None) -> Dict[str, Any]:
    """The journal as a ``trace_event`` JSON document (dict form)."""
    if spans is None:
        spans = _JOURNAL.snapshot()
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        tid = tids.setdefault(s.layer, len(tids) + 1)
        events.append(span_event(s.asdict(), pid=0, tid=tid))
    # the process name is part of the trace schema: both packages
    # write the same name, so a trace reads the same in either doctor
    meta = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "ompi_release_tpu"}},
    ] + [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
         "args": {"name": layer}}
        for layer, tid in sorted(tids.items(), key=lambda kv: kv[1])
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path: str,
                      spans: Optional[Sequence[Span]] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f)
    return path


def dump_jsonl(path: str, spans: Optional[Sequence[Span]] = None) -> str:
    if spans is None:
        spans = _JOURNAL.snapshot()
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.asdict()) + "\n")
    return path


# ---------------------------------------------------------------------------
# per-rank journal dump (the tpu-doctor merge input)
# ---------------------------------------------------------------------------


def rank_dump(clock_sync: bool = True) -> Dict[str, Any]:
    """This process's journal + identity + OOB clock offset as one
    JSON-able document — the unit ``tpu-doctor merge`` joins across
    ranks. ``clock_sync=True`` refreshes the offset against the HNP
    when an agent link exists (a few OOB round trips)."""
    from .. import obs as _obs

    meta: Dict[str, Any] = _obs.rank_identity()
    if clock_sync:
        try:
            from ..runtime.runtime import Runtime

            rt = Runtime._instance
            if rt is not None and rt.agent is not None:
                off, rtt = rt.agent.clock_sync()
                _obs.set_clock(off, rtt)
        except Exception:
            pass  # offset stays at its last/None value
    meta["clock_offset_s"] = _obs._clock_state["offset_s"]
    meta["clock_rtt_s"] = _obs._clock_state["rtt_s"]
    from . import sentinel as _sentinel

    if _sentinel.enabled:
        # the per-comm signature chains ride the finalize dump: the
        # doctor's contracts alignment can cross-check chain values
        # even when the journal ring wrapped past early rounds
        meta["sentinel"] = _sentinel.chains_snapshot()
    return {"meta": meta,
            "spans": [s.asdict() for s in _JOURNAL.snapshot()]}


def dump_rank_journal(path: str, clock_sync: bool = True) -> str:
    with open(path, "w") as f:
        json.dump(rank_dump(clock_sync=clock_sync), f)
    return path


def maybe_dump_rank_journal(runtime=None) -> Optional[str]:
    """Finalize hook: when ``obs_dump_dir`` is set (and obs is on),
    write this rank's journal dump there. Returns the path or None."""
    import os

    from ..mca import var as _var

    d = str(_var.get("obs_dump_dir", "") or "")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    pidx = 0
    if runtime is not None and runtime.bootstrap:
        pidx = int(runtime.bootstrap.get("process_index", 0))
    return dump_rank_journal(os.path.join(d, f"journal-p{pidx}.json"))


# ---------------------------------------------------------------------------
# continuous time-series (the sampler ring, obs/sampler.py)
# ---------------------------------------------------------------------------


def series_dump() -> Dict[str, Any]:
    """This process's continuous sampler ring + identity + clock
    offset as one JSON-able document — the TAG_SERIES RPC unit and
    the per-rank series-dump payload (same meta shape as
    :func:`rank_dump`, so the doctor's clock correction is shared)."""
    from .. import obs as _obs
    from . import sampler as _sampler

    meta: Dict[str, Any] = _obs.rank_identity()
    meta["clock_offset_s"] = _obs._clock_state["offset_s"]
    meta["clock_rtt_s"] = _obs._clock_state["rtt_s"]
    return {"meta": meta, "points": _sampler.snapshot()}


def dump_series_jsonl(path: str,
                      doc: Optional[Dict[str, Any]] = None) -> str:
    """Series dump as JSONL: first line is the meta header (tagged
    ``"meta"``), then one point per line — greppable, streamable, and
    what ``tpu-doctor`` merges with clock correction."""
    if doc is None:
        doc = series_dump()
    with open(path, "w") as f:
        f.write(json.dumps({"meta": doc["meta"]}) + "\n")
        for p in doc["points"]:
            f.write(json.dumps(p) + "\n")
    return path


def maybe_dump_series(runtime=None) -> Optional[str]:
    """Finalize hook: when ``obs_dump_dir`` is set (and obs is on),
    write this rank's time-series ring there as
    ``series-p<pidx>.jsonl``. Empty rings write nothing (sampler was
    never armed)."""
    import os

    from ..mca import var as _var
    from . import sampler as _sampler

    d = str(_var.get("obs_dump_dir", "") or "")
    if not d or not _sampler.snapshot():
        return None
    os.makedirs(d, exist_ok=True)
    pidx = 0
    if runtime is not None and runtime.bootstrap:
        pidx = int(runtime.bootstrap.get("process_index", 0))
    return dump_series_jsonl(os.path.join(d, f"series-p{pidx}.jsonl"))


def maybe_dump_ledger(runtime=None) -> Optional[str]:
    """Finalize hook: when ``obs_dump_dir`` is set, write this rank's
    compiled-fire flight recorder there as ``ledger-p<pidx>.json``
    (frozen-plan metadata + fixed-size fire records; tpu-doctor
    expands it into synthetic spans next to the journal dump). Empty
    rings write nothing (no compiled fire was observed)."""
    import os

    from ..mca import var as _var
    from . import ledger as _ledger

    d = str(_var.get("obs_dump_dir", "") or "")
    if not d or not _ledger.records():
        return None
    os.makedirs(d, exist_ok=True)
    pidx = 0
    if runtime is not None and runtime.bootstrap:
        pidx = int(runtime.bootstrap.get("process_index", 0))
    return _ledger.dump(os.path.join(d, f"ledger-p{pidx}.json"))


def maybe_dump_nativeev(runtime=None) -> Optional[str]:
    """Finalize hook: when ``obs_dump_dir`` is set and the native
    event ring is installed (``btl_nativewire_events``), write its
    decoded records there as ``nativeev-p<pidx>.json`` — tpu-doctor
    expands them into wire-layer spans whose flow ids pair across
    processes. No ring (the default) writes nothing."""
    import os

    from ..mca import var as _var
    from . import nativeev as _nativeev

    d = str(_var.get("obs_dump_dir", "") or "")
    if not d or _nativeev.get_ring() is None:
        return None
    os.makedirs(d, exist_ok=True)
    pidx = 0
    if runtime is not None and runtime.bootstrap:
        pidx = int(runtime.bootstrap.get("process_index", 0))
    return _nativeev.dump(os.path.join(d, f"nativeev-p{pidx}.json"))


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    n = _NAME_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return "ompitpu_" + n


def _help_line(m: str, help: str) -> str:
    return f"# HELP {m} " + " ".join(str(help).split())


def prometheus_text(registry: Optional[_pvar.PvarRegistry] = None) -> str:
    """Every registered pvar as Prometheus text exposition format."""
    reg = registry if registry is not None else _pvar.PVARS
    out: List[str] = []
    for d in reg.describe_all():
        name, pclass, value = d["name"], d["class"], d["value"]
        m = _metric_name(name)
        if pclass == "histogram" and isinstance(value, dict):
            out.append(_help_line(m, d["help"]))
            out.append(f"# TYPE {m} histogram")
            cum = 0
            for le in sorted(value.get("buckets", {})):
                cum += value["buckets"][le]
                out.append(f'{m}_bucket{{le="{float(le):g}"}} {cum}')
            out.append(f'{m}_bucket{{le="+Inf"}} {value["count"]}')
            out.append(f"{m}_sum {float(value['sum']):g}")
            out.append(f"{m}_count {value['count']}")
        elif pclass == "aggregate" and isinstance(value, dict):
            out.append(_help_line(m, d["help"]))
            for suffix in ("count", "sum", "min", "max"):
                out.append(f"# TYPE {m}_{suffix} gauge")
                out.append(f"{m}_{suffix} {float(value[suffix]):g}")
        else:
            try:
                fv = float(value)
            except (TypeError, ValueError):
                continue  # non-numeric getter pvar: not exposable
            ptype = "counter" if pclass in ("counter", "timer") else "gauge"
            out.append(_help_line(m, d["help"]))
            out.append(f"# TYPE {m} {ptype}")
            out.append(f"{m} {fv:g}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# OpenMetrics with timestamps (the time-series exposition)
# ---------------------------------------------------------------------------


def openmetrics_series(points: Optional[Sequence[Dict[str, Any]]] = None,
                       pidx: Optional[int] = None,
                       clock_offset_s: float = 0.0) -> str:
    """Sampler points as an OpenMetrics exposition **with
    timestamps** — every sample line carries its sample time (plus
    the given clock offset, so a merged fleet page sits on one
    timebase), labelled by communicator scope (``cid``) and owning
    process (``pidx`` — the argument, or each point's own ``pidx``
    key for pre-merged fleet points). Delta points are exposed as
    gauges (each point IS a per-interval delta — rate numerators);
    dict deltas (AGGREGATE/HISTOGRAM) expand to ``_count``/``_sum``
    plus ``p50``/``p99`` quantile-estimate gauges from the delta
    buckets. Spec discipline: every emitted sample name is its own
    gauge family, all of a family's samples are contiguous under ONE
    ``# TYPE`` line, and the text ends with ``# EOF`` — so one call
    over merged multi-process points yields a parseable page (never
    concatenate two expositions)."""
    from . import sampler as _sampler

    if points is None:
        points = _sampler.snapshot()
    # family name -> sample lines (insertion-ordered: families stay
    # grouped and contiguous as the spec requires)
    fams: Dict[str, List[str]] = {}

    def sample(fam: str, lab: str, value: float, ts: str) -> None:
        fams.setdefault(fam, []).append(f"{fam}{lab} {value:g} {ts}")

    for p in points:
        m = _metric_name(str(p.get("name", ""))) + "_delta"
        own = pidx if pidx is not None else p.get("pidx")
        labels = [f'cid="{int(p.get("cid", -1))}"']
        if own is not None:
            labels.insert(0, f'pidx="{int(own)}"')
        lab = "{" + ",".join(labels) + "}"
        ts = f"{float(p['t']) + clock_offset_s:.6f}"
        v = p.get("v")
        if isinstance(v, dict):
            sample(m + "_count", lab, float(v.get("count", 0)), ts)
            sample(m + "_sum", lab, float(v.get("sum", 0.0)), ts)
            buckets = v.get("buckets")
            if isinstance(buckets, dict) and buckets:
                for q, tag in ((0.5, "p50"), (0.99, "p99")):
                    est = _sampler.percentile(buckets, q)
                    if est is not None:
                        sample(f"{m}_{tag}", lab, est, ts)
        else:
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            sample(m, lab, fv, ts)
    out: List[str] = []
    for fam, lines in fams.items():
        out.append(f"# TYPE {fam} gauge")
        out.extend(lines)
    out.append("# EOF")
    return "\n".join(out) + "\n"
