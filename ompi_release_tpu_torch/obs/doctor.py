"""Job-level trace assembly — merge per-rank journals, draw flows,
name the slow rank.

Input: one :func:`obs.export.rank_dump` document per controller
process (written at finalize via ``obs_dump_dir``, embedded in
postmortems, or fetched over the ``tpu_server`` journal RPC). Each
carries the rank identity and the OOB clock offset mapping that
process's ``perf_counter`` timebase into the HNP's.

Output:

- :func:`merge`: ONE Perfetto/Chrome ``trace_event`` document — pid =
  controller process (named with its world-rank span), tid = layer,
  timestamps clock-offset-corrected, and **flow arrows** joining every
  producer span ("s" side) to its consumer span ("t" side) by the
  deterministic flow ids the emit points stamped (p2p envelope seq,
  hier round/pair/index, window request token).
- :func:`skew_report`: per (comm, op) collective-round table — round k
  is the k-th occurrence of that op on each process (collective call
  order is identical everywhere, MPI's own rule), arrival spread is
  max-min corrected start, and the LAST arriver is the critical-path
  rank for that round.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .export import span_event


def load_dump(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if "spans" not in doc or "meta" not in doc:
        raise ValueError(f"{path}: not a rank journal dump "
                         "(missing meta/spans)")
    return doc


def load_dir(directory: str) -> List[Dict[str, Any]]:
    """Every ``journal-p*.json`` under ``directory``, plus — for ranks
    that never finalized (a hung rank killed mid-job leaves ONLY
    postmortems) — the journal tail of that rank's newest
    ``postmortem-*.json``. ``ledger-p*.json`` flight-recorder dumps
    are expanded against their frozen-plan metadata into synthetic
    spans and merged into the matching rank's span list (compiled
    fires carry the interpreted path's flow ids, so flow arrows and
    skew rounds include compiled traffic)."""
    dumps = []
    for p in sorted(glob.glob(os.path.join(directory, "journal-p*.json"))):
        dumps.append(load_dump(p))
    finalized = {int(d["meta"].get("pidx", 0)) for d in dumps}
    # one postmortem dump per missing rank: a hung rank routinely
    # writes SEVERAL postmortems (one per newly stalled wait, plus
    # operator SIGUSR1 pokes) whose journal tails overlap — merging
    # them all would render that rank's spans twice and desync the
    # skew report's tail alignment. Keep only the newest per pidx
    # (latest time_unix: the longest journal tail), and only for
    # ranks without a finalize-time journal (which supersedes tails).
    newest: Dict[int, Tuple[float, Dict[str, Any]]] = {}
    for p in sorted(glob.glob(os.path.join(directory,
                                           "postmortem-*.json"))):
        with open(p) as f:
            pm = json.load(f)
        tail = pm.get("journal_tail")
        if not isinstance(tail, list):
            continue
        rank = pm.get("rank", {})
        clock = pm.get("clock", {}) or {}
        pidx = int(rank.get("pidx", 0))
        if pidx in finalized:
            continue
        t = float(pm.get("time_unix", 0.0) or 0.0)
        prev = newest.get(pidx)
        if prev is not None and prev[0] >= t:
            continue
        newest[pidx] = (t, {
            "meta": {"pidx": pidx,
                     "rank_offset": rank.get("rank_offset", 0),
                     "local_size": rank.get("local_size", 0),
                     "pid": rank.get("pid"),
                     "clock_offset_s": clock.get("offset_s"),
                     "clock_rtt_s": clock.get("rtt_s")},
            "spans": tail,
        })
    dumps.extend(d for _, (_, d) in sorted(newest.items()))
    attach_ledgers(dumps, directory)
    attach_native_events(dumps, directory)
    dumps.sort(key=lambda d: int(d["meta"].get("pidx", 0)))
    if not dumps:
        raise FileNotFoundError(
            f"no journal-p*.json, postmortem-*.json, ledger-p*.json, "
            f"or nativeev-p*.json dumps under {directory} (set --mca "
            "obs_dump_dir, or send SIGUSR1 to the ranks first)")
    return dumps


def load_ledger_dump(path: str) -> Dict[str, Any]:
    from . import ledger as _ledger

    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != _ledger.FORMAT:
        raise ValueError(f"{path}: not a flight-recorder ledger dump "
                         f"(format != {_ledger.FORMAT})")
    return doc


def attach_ledgers(dumps: List[Dict[str, Any]],
                   directory: str) -> None:
    """Expand every ``ledger-p*.json`` under ``directory`` into
    synthetic spans and merge them into the matching rank's dump (a
    rank with no journal dump gets a fresh one from the ledger's own
    identity). The combined span list is re-sorted by start time so
    the skew report's call-order round alignment holds across real
    and synthetic spans."""
    from . import ledger as _ledger

    by_pidx = {int(d["meta"].get("pidx", 0)): d for d in dumps}
    for p in sorted(glob.glob(os.path.join(directory,
                                           "ledger-p*.json"))):
        try:
            doc = load_ledger_dump(p)
        except (ValueError, OSError):
            continue
        spans = _ledger.expand_dump(doc)
        if not spans:
            continue
        meta = doc.get("meta") or {}
        pidx = int(meta.get("pidx", 0))
        host = by_pidx.get(pidx)
        if host is None:
            host = by_pidx[pidx] = {
                "meta": {"pidx": pidx,
                         "rank_offset": meta.get("rank_offset", 0),
                         "local_size": meta.get("local_size", 0),
                         "pid": meta.get("pid"),
                         "clock_offset_s": doc.get("clock_offset_s"),
                         "clock_rtt_s": None},
                "spans": []}
            dumps.append(host)
        host["spans"] = sorted(
            list(host["spans"]) + spans,
            key=lambda s: float(s.get("t", 0.0)))
        host.pop("_corrected_spans", None)


def load_nativeev_dump(path: str) -> Dict[str, Any]:
    from . import nativeev as _nativeev

    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != _nativeev.FORMAT:
        raise ValueError(f"{path}: not a native event-ring dump "
                         f"(format != {_nativeev.FORMAT})")
    return doc


def attach_native_events(dumps: List[Dict[str, Any]],
                         directory: str) -> None:
    """Expand every ``nativeev-p*.json`` under ``directory`` into
    wire-layer spans and merge them into the matching rank's dump —
    the :func:`attach_ledgers` discipline for the zero-copy datapath.
    Send/recv records carry flow ids re-derived from the SGC2 (tag,
    xfer, idx) triple, so :func:`flow_pairs` and :func:`merge` draw
    cross-process arrows for fragments Python never touched."""
    from . import nativeev as _nativeev

    by_pidx = {int(d["meta"].get("pidx", 0)): d for d in dumps}
    for p in sorted(glob.glob(os.path.join(directory,
                                           "nativeev-p*.json"))):
        try:
            doc = load_nativeev_dump(p)
        except (ValueError, OSError):
            continue
        spans = _nativeev.expand_dump(doc)
        if not spans:
            continue
        meta = doc.get("meta") or {}
        pidx = int(meta.get("pidx", 0))
        host = by_pidx.get(pidx)
        if host is None:
            host = by_pidx[pidx] = {
                "meta": {"pidx": pidx,
                         "rank_offset": meta.get("rank_offset", 0),
                         "local_size": meta.get("local_size", 0),
                         "pid": meta.get("pid"),
                         "clock_offset_s": doc.get("clock_offset_s"),
                         "clock_rtt_s": None},
                "spans": []}
            dumps.append(host)
        host["spans"] = sorted(
            list(host["spans"]) + spans,
            key=lambda s: float(s.get("t", 0.0)))
        host.pop("_corrected_spans", None)


def _offset(meta: Dict[str, Any]) -> float:
    off = meta.get("clock_offset_s")
    return float(off) if off is not None else 0.0


def _corrected(dump: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Spans with a ``ts`` key in the merged (HNP) timebase, seconds.
    Cached on the dump: merge(), flow_pairs(), and _coll_rounds() all
    walk the same spans (a `tpu-doctor report` hits all three), and at
    job scale recomputing means millions of redundant dict copies. The
    spans are read-only downstream, so one shared list is safe."""
    cached = dump.get("_corrected_spans")
    if cached is None:
        off = _offset(dump["meta"])
        cached = []
        for s in dump["spans"]:
            c = dict(s)
            c["ts"] = float(s["t"]) + off
            cached.append(c)
        dump["_corrected_spans"] = cached
    return cached


def flow_pairs(dumps: List[Dict[str, Any]]
               ) -> List[Dict[str, Any]]:
    """Matched (producer, consumer) span pairs across dumps: one entry
    per flow id seen with both sides. Producer/consumer carry the
    owning pidx so callers can tell cross-process flows apart."""
    sides: Dict[int, Dict[str, List[Tuple[int, Dict]]]] = {}
    for d in dumps:
        pidx = int(d["meta"].get("pidx", 0))
        for s in _corrected(d):
            fl = s.get("flow")
            if not fl:
                continue
            side = "s" if s.get("fs") == "s" else "t"
            sides.setdefault(int(fl), {"s": [], "t": []})[side].append(
                (pidx, s))
    pairs = []
    for fl, ends in sorted(sides.items()):
        if not ends["s"] or not ends["t"]:
            continue
        # multiple spans per id would mean an id collision (64-bit FNV
        # over distinct identifiers: vanishingly rare) — pair in order
        for (sp, ss), (tp, ts) in zip(ends["s"], ends["t"]):
            pairs.append({"flow": fl, "src_pidx": sp, "dst_pidx": tp,
                          "src": ss, "dst": ts,
                          "cross_process": sp != tp,
                          "latency_s": ts["ts"] - (ss["ts"] + ss["dt"])})
    return pairs


def merge(dumps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One clock-aligned Perfetto trace for the whole job."""
    events: List[Dict[str, Any]] = []
    meta_events: List[Dict[str, Any]] = []
    tids: Dict[Tuple[int, str], int] = {}
    for d in sorted(dumps, key=lambda d: int(d["meta"].get("pidx", 0))):
        m = d["meta"]
        pidx = int(m.get("pidx", 0))
        off0 = int(m.get("rank_offset", 0))
        n = int(m.get("local_size", 0))
        label = (f"proc {pidx} (world ranks {off0}..{off0 + n - 1})"
                 if n else f"proc {pidx}")
        meta_events.append({"name": "process_name", "ph": "M",
                            "pid": pidx, "args": {"name": label}})
        for s in _corrected(d):
            key = (pidx, s["layer"])
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len(tids) + 1
                meta_events.append({
                    "name": "thread_name", "ph": "M", "pid": pidx,
                    "tid": tid, "args": {"name": s["layer"]},
                })
            events.append(span_event(s, pid=pidx, tid=tid,
                                     ts_s=s["ts"]))
    flows = flow_pairs(dumps)
    for p in flows:
        src, dst = p["src"], p["dst"]
        src_tid = tids.get((p["src_pidx"], src["layer"]), 1)
        dst_tid = tids.get((p["dst_pidx"], dst["layer"]), 1)
        fid = str(p["flow"])
        events.append({
            "name": src["op"], "cat": "flow", "ph": "s", "id": fid,
            "pid": p["src_pidx"], "tid": src_tid,
            "ts": (src["ts"] + src["dt"]) * 1e6,
        })
        events.append({
            "name": src["op"], "cat": "flow", "ph": "f", "bp": "e",
            "id": fid, "pid": p["dst_pidx"], "tid": dst_tid,
            "ts": (dst["ts"] + dst["dt"]) * 1e6,
        })
    doc = {"traceEvents": meta_events + events, "displayTimeUnit": "ms"}
    doc["otherData"] = {
        "processes": len(dumps),
        "spans": sum(len(d["spans"]) for d in dumps),
        "flows": len(flows),
        "cross_process_flows": sum(1 for p in flows
                                   if p["cross_process"]),
    }
    return doc



# ---------------------------------------------------------------------------
# continuous series (obs/sampler.py rings) — load, clock-correct, merge
# ---------------------------------------------------------------------------


def load_series_dump(path: str) -> Dict[str, Any]:
    """One ``series-p*.jsonl`` file (meta header line + one point per
    line, ``obs.export.dump_series_jsonl``) back into the
    ``{"meta": ..., "points": [...]}`` document shape."""
    meta: Dict[str, Any] = {}
    points: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if "meta" in doc and "t" not in doc:
                meta = doc["meta"]
            else:
                points.append(doc)
    if not meta and not points:
        raise ValueError(f"{path}: empty series dump")
    return {"meta": meta, "points": points}


def load_series_dir(directory: str) -> List[Dict[str, Any]]:
    """Every ``series-p*.jsonl`` under ``directory``, ordered by
    pidx. Missing files are not an error here — callers that can
    proceed without series (the report annotation) check for []."""
    docs = []
    for p in sorted(glob.glob(os.path.join(directory,
                                           "series-p*.jsonl"))):
        docs.append(load_series_dump(p))
    docs.sort(key=lambda d: int(d["meta"].get("pidx", 0)))
    return docs


def merge_series(docs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One clock-corrected fleet series: every point gains ``ts``
    (sample time mapped into the HNP timebase via the dump's clock
    offset — the same correction journals get) and ``pidx``, merged
    across processes and sorted by corrected time."""
    merged: List[Dict[str, Any]] = []
    for d in docs:
        off = _offset(d["meta"])
        pidx = int(d["meta"].get("pidx", 0))
        for p in d["points"]:
            c = dict(p)
            c["ts"] = float(p["t"]) + off
            c["pidx"] = pidx
            merged.append(c)
    merged.sort(key=lambda p: p["ts"])
    return merged


def fleet_to_series_docs(fleet: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A live HNP fleet document (``HnpCoordinator.fleet_series``)
    reshaped into the same per-process doc list the offline loaders
    produce, so merge_series/tpu_top render both identically."""
    docs = []
    for pidx_s, ent in sorted((fleet.get("procs") or {}).items(),
                              key=lambda kv: int(kv[0])):
        meta = dict(ent.get("meta") or {})
        meta.update(pidx=int(pidx_s),
                    clock_offset_s=ent.get("clock_offset_s"),
                    push_age_s=ent.get("push_age_s"))
        docs.append({"meta": meta,
                     "points": list(ent.get("points") or ())})
    return docs


def series_rates(merged: List[Dict[str, Any]]
                 ) -> Dict[int, Dict[str, float]]:
    """Per-process sampled collective rates over the merged window:
    pidx -> {"window_s", "coll_ops_per_s", "coll_mb_per_s",
    "coll_busy_frac"} folded from the per-cid ``coll_*`` delta points.
    The doctor report annotates its critical path with these — a rank
    that is both the chronic last-arriver AND the lowest-rate rank is
    compute-bound, not network-starved."""
    by_pidx: Dict[int, Dict[str, float]] = {}
    spans: Dict[int, List[float]] = {}
    for p in merged:
        pidx = int(p.get("pidx", 0))
        name = p.get("name")
        if name not in ("coll_ops", "coll_bytes", "coll_seconds"):
            continue
        acc = by_pidx.setdefault(
            pidx, {"coll_ops": 0.0, "coll_bytes": 0.0,
                   "coll_seconds": 0.0})
        try:
            acc[name] += float(p.get("v", 0.0))
        except (TypeError, ValueError):
            continue
        spans.setdefault(pidx, []).append(float(p["ts"]))
    out: Dict[int, Dict[str, float]] = {}
    for pidx, acc in sorted(by_pidx.items()):
        ts = sorted(set(spans.get(pidx) or ()))
        if len(ts) < 2:
            # a single tick has no measurable window — omitting the
            # proc beats reporting a made-up (and wildly inflated) rate
            continue
        window = max(ts[-1] - ts[0], 1e-9)
        out[pidx] = {
            "window_s": window,
            "coll_ops_per_s": acc["coll_ops"] / window,
            "coll_mb_per_s": acc["coll_bytes"] / window / 1e6,
            "coll_busy_frac": min(acc["coll_seconds"] / window, 1.0),
        }
    return out


# ---------------------------------------------------------------------------
# collective contract alignment (obs/sentinel.py signature events)
# ---------------------------------------------------------------------------


def sentinel_records(dumps: List[Dict[str, Any]],
                     directory: Optional[str] = None
                     ) -> Dict[int, Dict[int, Dict[int, Dict[str, Any]]]]:
    """Per-comm signature records: cid -> pidx -> posting seq ->
    ``{"canon", "family", "epoch", "site"}``. Two sources, deduped by
    (pidx, cid, seq):

    - journal spans with layer ``"sentinel"`` (finalize dumps and
      postmortem journal tails — ``load_dir`` already folds both);
    - the per-comm last-N signature rings: the ``"sentinel"``
      watchdog-contributor block of postmortem files under
      ``directory`` AND the finalize dump's ``meta["sentinel"]`` —
      both survive a journal wrap past the divergent round.
    """
    from .sentinel import parse_op

    out: Dict[int, Dict[int, Dict[int, Dict[str, Any]]]] = {}

    def put(pidx: int, cid: int, seq: int, rec: Dict[str, Any]) -> None:
        out.setdefault(cid, {}).setdefault(pidx, {}).setdefault(seq, rec)

    def put_rings(pidx: int, sent: Any) -> None:
        if not isinstance(sent, dict):
            return
        for cid_s, ent in (sent.get("comms") or {}).items():
            for drec in ent.get("last") or ():
                canon = str(drec.get("canon", ""))
                put(pidx, int(cid_s), int(drec.get("seq", -1)),
                    {"canon": canon,
                     "family": canon.split("|", 1)[0],
                     "epoch": int(drec.get("epoch", 0)),
                     "site": str(drec.get("site", "?"))})

    for d in dumps:
        pidx = int(d["meta"].get("pidx", 0))
        for s in d["spans"]:
            if s.get("layer") != "sentinel":
                continue
            parsed = parse_op(str(s.get("op", "")))
            if parsed is None:
                continue
            put(pidx, int(s.get("comm", -1)), int(s.get("peer", -1)),
                parsed)
        put_rings(pidx, d["meta"].get("sentinel"))
    if directory:
        for p in sorted(glob.glob(os.path.join(directory,
                                               "postmortem-*.json"))):
            with open(p) as f:
                pm = json.load(f)
            put_rings(int((pm.get("rank") or {}).get("pidx", 0)),
                      pm.get("sentinel"))
    return out


def _first_divergence(per_pid: Dict[int, Dict[int, Dict[str, Any]]]
                      ) -> Optional[Dict[str, Any]]:
    """The first contract divergence of one comm's per-proc signature
    sequences, or None. Procs are compared only over posting seqs
    every window can still see (ring journals keep the newest spans;
    a seq below a proc's window floor is wrap loss, not evidence)."""
    participants = sorted(per_pid)
    lo = {p: min(per_pid[p]) for p in participants}
    hi = {p: max(per_pid[p]) for p in participants}
    all_seqs = sorted({s for recs in per_pid.values() for s in recs})
    for seq in all_seqs:
        present = {p: per_pid[p][seq] for p in participants
                   if seq in per_pid[p]}
        # a proc whose whole window sits PAST seq only wrapped; a proc
        # whose window ENDS before seq never posted it — the missing
        # participant (the hung-run shape: survivors at seq k+1, the
        # desynced rank's chain stops at k)
        missing = [p for p in participants
                   if seq not in per_pid[p] and hi[p] < seq]
        gapped = [p for p in participants
                  if seq not in per_pid[p]
                  and lo[p] <= seq <= hi[p]]
        if missing:
            return {"kind": "missing_participant", "seq": seq,
                    "missing": missing,
                    "posted": {p: r for p, r in present.items()},
                    "last": {p: per_pid[p][hi[p]] for p in missing}}
        if gapped or len(present) < len(participants):
            continue  # journal gap / wrap: not comparable at this seq
        canons = {p: r["canon"] for p, r in present.items()}
        if len(set(canons.values())) > 1:
            # the expected signature is the MAJORITY canon (ties break
            # to the lowest pidx's), so the culprit is attributed even
            # when proc 0 itself is the desynced rank
            votes: Dict[str, int] = {}
            for p in participants:
                votes[canons[p]] = votes.get(canons[p], 0) + 1
            expected_canon = max(
                votes, key=lambda c: (votes[c], -min(
                    p for p in participants if canons[p] == c)))
            divergent = next(p for p in participants
                             if canons[p] != expected_canon)
            agree = [p for p in participants
                     if canons[p] == expected_canon]
            authority = agree[0]
            nxt_a = per_pid[authority].get(seq + 1)
            nxt_d = per_pid[divergent].get(seq + 1)
            swap = (nxt_a is not None and nxt_d is not None
                    and nxt_d["canon"] == canons[authority]
                    and nxt_a["canon"] == canons[divergent])
            return {"kind": ("posting_order_swap" if swap
                             else "signature_mismatch"),
                    "seq": seq, "divergent": divergent,
                    "agreeing": agree,
                    "expected": present[authority],
                    "actual": present[divergent]}
        epochs = {p: int(r.get("epoch", 0)) for p, r in present.items()}
        if len(set(epochs.values())) > 1:
            # transient skew is legal: FT notices propagate
            # asynchronously over lifelines, so a healthy rank can
            # post one round with a one-behind epoch view. Only a
            # skew that never converges over the remaining common
            # window is the stale-epoch-survivor signal.
            if _epochs_converge_later(per_pid, participants, seq):
                continue
            stale = min(epochs, key=lambda p: (epochs[p], p))
            fresh = max((p for p in participants if p != stale),
                        key=lambda p: (epochs[p], -p))
            return {"kind": "epoch_skew", "seq": seq,
                    "divergent": stale, "epochs": epochs,
                    "expected": present[fresh],
                    "actual": present[stale]}
    return None


def _epochs_converge_later(per_pid, participants, seq: int) -> bool:
    """True when some LATER seq present on every participant shows one
    agreed epoch — the skew at ``seq`` was notice-propagation lag, not
    a stale survivor."""
    later = sorted(s for s in per_pid[participants[0]] if s > seq)
    for s in later:
        if any(s not in per_pid[p] for p in participants):
            continue
        es = {int(per_pid[p][s].get("epoch", 0)) for p in participants}
        if len(es) == 1:
            return True
    return False


def contract_report(dumps: List[Dict[str, Any]],
                    directory: Optional[str] = None
                    ) -> Tuple[str, Dict[str, Any]]:
    """Align per-comm posting sequences across ranks and name the
    first divergence per comm — the post-hoc half of the collective
    contract sentinel (``obs_sentinel=1``). Works from finalize-time
    journals AND from watchdog postmortems of a hung run."""
    table = sentinel_records(dumps, directory=directory)
    lines = ["tpu-doctor collective-contract report"]
    comms: Dict[str, Any] = {}
    divergences = 0
    for cid in sorted(table):
        per_pid = table[cid]
        participants = sorted(per_pid)
        n_sigs = sum(len(v) for v in per_pid.values())
        if len(participants) < 2:
            comms[str(cid)] = {"participants": participants,
                               "signatures": n_sigs,
                               "divergence": None}
            continue
        div = _first_divergence(per_pid)
        comms[str(cid)] = {"participants": participants,
                           "signatures": n_sigs, "divergence": div}
        if div is None:
            lines.append(
                f"  comm {cid}: {n_sigs} signature(s) aligned across "
                f"procs {participants} — no divergence")
            continue
        divergences += 1
        seq = div["seq"]
        if div["kind"] == "missing_participant":

            def fmt_last(p):
                r = div["last"][p]
                return f"proc {p} last posted {r['canon']} from " \
                       f"{r['site']}"

            posted = next(iter(div["posted"].values()), None)
            lines.append(
                f"  comm {cid}: DESYNC at seq {seq} — "
                f"proc(s) {div['missing']} never posted it; "
                f"procs {sorted(div['posted'])} posted "
                f"{posted['canon'] if posted else '?'} from "
                f"{posted['site'] if posted else '?'}; "
                + "; ".join(fmt_last(p) for p in div["missing"]))
        elif div["kind"] == "epoch_skew":
            lines.append(
                f"  comm {cid}: DESYNC at seq {seq} — epoch skew: "
                f"proc {div['divergent']} posted at epoch "
                f"{div['epochs'][div['divergent']]} where others were "
                f"at {max(div['epochs'].values())} (stale-epoch "
                f"survivor?)")
        else:
            exp, act = div["expected"], div["actual"]
            tag = (" [posting-order swap: the two procs posted the "
                   "same ops in opposite order at seq "
                   f"{seq}/{seq + 1}]"
                   if div["kind"] == "posting_order_swap" else "")
            lines.append(
                f"  comm {cid}: DESYNC at seq {seq} — proc "
                f"{div['divergent']} posted {act['canon']} from "
                f"{act['site']} where proc(s) {div['agreeing']} "
                f"posted {exp['canon']} from {exp['site']}{tag}")
    if not table:
        lines.append("  no sentinel signature events found (run with "
                     "--mca obs_sentinel 1, plus obs_dump_dir or a "
                     "postmortem dir)")
    elif not divergences:
        lines.append("  all collective call streams agree")
    return "\n".join(lines), {"comms": comms,
                              "divergences": divergences}


# ---------------------------------------------------------------------------
# incident timeline (ft journal events: failures, revokes, recoveries)
# ---------------------------------------------------------------------------


def incident_timeline(dumps: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """The fleet's fault-tolerance story from merged journals: every
    ``ft_failure`` / ``ft_revoke`` / ``ft_recovery`` span (``ft/ulfm``
    and ``parallel/elastic`` record them; this renders them),
    clock-corrected and sorted.
    Field use per event kind follows the emitters: failure carries
    (peer=failed pidx, comm=epoch), revoke (comm=cid, peer=epoch),
    recovery (comm=new cid, peer=step, dt=duration)."""
    evs: List[Dict[str, Any]] = []
    for d in dumps:
        pidx = int(d["meta"].get("pidx", 0))
        for s in _corrected(d):
            if s["layer"] != "ft":
                continue
            op = s["op"]
            ev = {"ts": s["ts"], "pidx": pidx, "op": op}
            if op == "ft_failure":
                ev.update(failed_pidx=int(s.get("peer", -1)),
                          epoch=int(s.get("comm", 0)))
            elif op == "ft_revoke":
                ev.update(cid=int(s.get("comm", -1)),
                          epoch=int(s.get("peer", 0)))
            elif op == "ft_recovery":
                ev.update(new_cid=int(s.get("comm", -1)),
                          step=int(s.get("peer", -1)),
                          duration_s=float(s.get("dt", 0.0)))
            evs.append(ev)
    evs.sort(key=lambda e: e["ts"])
    return evs


def incident_lines(events: List[Dict[str, Any]]) -> List[str]:
    """Render the timeline for the report (times relative to the
    first incident)."""
    if not events:
        return []
    t0 = events[0]["ts"]
    lines = ["  incident timeline (ft events across merged journals):"]
    for e in events:
        rel = e["ts"] - t0
        if e["op"] == "ft_failure":
            what = (f"learned process {e['failed_pidx']} FAILED "
                    f"(epoch -> {e['epoch']})")
        elif e["op"] == "ft_revoke":
            what = f"revoked cid {e['cid']} (epoch {e['epoch']})"
        elif e["op"] == "ft_recovery":
            # the peer slot carries the step the FAILURE hit (the
            # rollback target is only in the ft_steps_lost pvar)
            what = (f"recovered in {e['duration_s']:.3f}s (resumed "
                    f"on cid {e['new_cid']}, failure at step "
                    f"{e['step']})")
        else:
            what = e["op"]
        lines.append(f"    +{rel:8.3f}s proc {e['pidx']}: {what}")
    return lines


def _coll_rounds(dumps: List[Dict[str, Any]]
                 ) -> Dict[Tuple[int, str], Dict[int, List[Dict]]]:
    """(comm, op) -> pidx -> that pid's coll-layer spans in call
    order. Only the 'coll' layer counts as a round marker (hier and
    driver both stamp it)."""
    table: Dict[Tuple[int, str], Dict[int, List[Dict]]] = {}
    for d in dumps:
        pidx = int(d["meta"].get("pidx", 0))
        for s in _corrected(d):
            if s["layer"] != "coll":
                continue
            table.setdefault((int(s.get("comm", -1)), s["op"]), {}) \
                .setdefault(pidx, []).append(s)
    return table


def skew_report(dumps: List[Dict[str, Any]],
                series: Optional[List[Dict[str, Any]]] = None
                ) -> Tuple[str, Dict[str, Any]]:
    """Critical-path + rank-skew report: for every collective round
    observed on EVERY process, name the last arriver (the rank the
    round waited for) and the arrival spread. When ``series`` (the
    per-process docs from :func:`load_series_dir` or
    :func:`fleet_to_series_docs`) is given, the critical path is
    annotated with each process's sampled collective rates."""
    by_pid_ranks = {
        int(d["meta"].get("pidx", 0)): (
            int(d["meta"].get("rank_offset", 0)),
            int(d["meta"].get("local_size", 0)))
        for d in dumps
    }

    def rank_span(pidx: int) -> str:
        off, n = by_pid_ranks.get(pidx, (0, 0))
        return f"ranks {off}..{off + n - 1}" if n else "ranks ?"

    rounds_out: List[Dict[str, Any]] = []
    crit_count: Dict[int, int] = {}
    lateness: Dict[int, float] = {}
    for (comm, op), per_pid in sorted(_coll_rounds(dumps).items()):
        if len(per_pid) < 2:
            continue  # a round needs >= 2 processes to have skew
        # align rounds from the TAIL: ring journals keep the NEWEST
        # spans, so when ranks wrapped or truncated differently the
        # common suffix is the set of rounds every dump still holds —
        # head alignment would pair different rounds and blame the
        # wrong rank (finalize-time dumps all end at the job's last
        # collective, making the suffix exact)
        n_rounds = min(len(v) for v in per_pid.values())
        tails = {p: v[-n_rounds:] for p, v in per_pid.items()}
        for k in range(n_rounds):
            arrivals = {p: tails[p][k]["ts"] for p in per_pid}
            slow = max(arrivals, key=arrivals.get)
            fast = min(arrivals, key=arrivals.get)
            spread = arrivals[slow] - arrivals[fast]
            crit_count[slow] = crit_count.get(slow, 0) + 1
            lateness[slow] = lateness.get(slow, 0.0) + spread
            rounds_out.append({
                "comm": comm, "op": op, "round": k,
                "slowest_pidx": slow, "spread_s": spread,
                "arrivals": {str(p): arrivals[p] for p in arrivals},
            })
    lines = ["tpu-doctor rank-skew / critical-path report",
             f"  processes: {len(dumps)}  collective rounds: "
             f"{len(rounds_out)}"]
    worst = sorted(rounds_out, key=lambda r: -r["spread_s"])[:10]
    if worst:
        lines.append("  worst rounds by arrival spread:")
        for r in worst:
            lines.append(
                f"    comm {r['comm']} {r['op']} round {r['round']}: "
                f"spread {r['spread_s'] * 1e3:.3f} ms, slowest proc "
                f"{r['slowest_pidx']} ({rank_span(r['slowest_pidx'])})")
    if crit_count:
        lines.append("  critical-path share (times slowest / total "
                     "lateness):")
        for p in sorted(crit_count, key=lambda p: -crit_count[p]):
            lines.append(
                f"    proc {p} ({rank_span(p)}): {crit_count[p]} "
                f"round(s), {lateness[p] * 1e3:.3f} ms accumulated")
    else:
        lines.append("  no multi-process collective rounds found "
                     "(was obs enabled on every rank?)")
    rates: Dict[int, Dict[str, float]] = {}
    if series:
        rates = series_rates(merge_series(series))
        if rates:
            lines.append("  sampled rates (continuous metrics plane):")
            for p in sorted(rates):
                r = rates[p]
                lines.append(
                    f"    proc {p} ({rank_span(p)}): "
                    f"{r['coll_ops_per_s']:.1f} coll/s, "
                    f"{r['coll_mb_per_s']:.2f} MB/s, "
                    f"busy {r['coll_busy_frac'] * 100:.1f}% over "
                    f"{r['window_s']:.1f}s sampled")
    incidents = incident_timeline(dumps)
    if incidents:
        lines.extend(incident_lines(incidents))
    return "\n".join(lines), {"rounds": rounds_out,
                              "critical_path": crit_count,
                              "sampled_rates": {str(p): r for p, r
                                                in rates.items()},
                              "incidents": incidents}
