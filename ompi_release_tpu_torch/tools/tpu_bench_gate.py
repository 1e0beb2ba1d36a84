"""tpu-bench-gate — make the perf trajectory trustworthy.

Round records (``BENCH_r*.json``, or a bench's JSONL output) are the
longitudinal perf evidence; without a reader a regression has to be
noticed by a human diffing JSON, and a round that silently lost its
device metrics goes unseen. This tool closes the loop:

1. parse every historical round's metric lines (the ``tail`` JSONL of
   a round record, or a plain JSONL file from ``bench.py``);
2. group lines by ``(metric, tier)`` — the tier label keeps
   loopback-CPU fallback rounds from contaminating TPU noise fits;
3. fit a robust noise bound per line (median ± sigma × MAD-scale,
   floored at a relative band, because the measured HBM ceiling
   wobbles ±20% session to session — see bench.py's ceiling notes);
4. exit non-zero when the candidate round regresses past the bound in
   the metric's *bad* direction (lower for bandwidths/speedups,
   higher for latencies/wait times).

Lines that are not comparable are skipped, never gated: null values,
``unstable`` / ``partial_rounds`` / ``error`` markers, units with no
known good direction, and metrics with fewer than ``--min-rounds``
clean historical points.

Usage::

    # newest BENCH_r*.json is the candidate, the rest are history
    python -m ompi_release_tpu_torch.tools.tpu_bench_gate BENCH_r*.json

    # explicit candidate (e.g. a fresh bench run's JSONL output)
    python -m ompi_release_tpu_torch.tools.tpu_bench_gate BENCH_r*.json \
        --candidate fresh.jsonl

The JAX package's ``bench.py`` also runs :func:`evaluate` in-process at
the end of every round; the port's bench does not (it has no round
history yet), so the port runs the gate as a tool only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: units where bigger is better (bandwidths, throughputs, speedups,
#: hidden-comm fractions from the overlap suite)
HIGHER_BETTER = {"GB/s", "TFLOP/s", "frac_hidden"}
#: units where smaller is better (latencies, waits, message counts)
LOWER_BETTER = {"s", "seconds", "us", "us/hop", "hol_wait_s",
                "sends_at_root", "device_collectives", "steps",
                "copies/MiB"}
#: metric-name fallback when the unit alone is ambiguous: the overlap
#: suite's lines (hidden-comm fraction, overlap speedups), the
#: tree_overlap suite's lines (planned-pass speedup, whole-tree
#: hidden-comm fraction, nonblocking-pipeline speedup), and the
#: steady_state suite's compiled_* lines (interpreted-vs-compiled
#: orchestration speedups) are all higher-better — less comm or
#: Python time exposed on the critical path. The fleet_scaling
#: suite's topo_* lines (topology-aware schedule speedups over the
#: flat ring: inter-host byte ratio, virtual-makespan ratio) are
#: higher-better too — a shrunk ratio means the torus/multiring
#: advantage regressed.
METRIC_HIGHER_BETTER_PREFIXES = ("overlap_", "tree_", "compiled_",
                                 "topo_")
#: ...and the ft_recovery suite's lines (recovery wall time, steps
#: recomputed after rollback) and the contract-sentinel suite's lines
#: (per-collective overhead, enabled AND disabled legs) are all
#: lower-better — the sentinel's "near-zero overhead when off" claim
#: is gate-enforced across rounds, like any latency regression.
#: The fleet_scaling suite's sim_* lines (simulated-fleet schedule
#: round counts, bytes per rank, virtual-clock makespan) are
#: lower-better too: they are DETERMINISTIC functions of the schedule
#: code over the fabric model (tier_label "sim" keeps them out of the
#: wall-clock tiers' fits), so a tripped bound is a real scaling
#: regression — a schedule doing more rounds or shipping more bytes
#: at the same P — not measurement noise. The steady_state suite's
#: steady_* lines (per-op wall and Python-orchestration seconds for
#: interpreted and compiled legs) are lower-better latencies. The
#: multi_tenant suite's tenant_* lines (latency-tenant p99 solo /
#: contended / FIFO, and the tenant_latency_isolation degradation
#: ratio — the service plane's isolation bound) are lower-better on
#: the same sim tier: a grown isolation ratio means the weighted-fair
#: wire lets a bulk tenant degrade a latency tenant further.
#: The flight-recorder lines are lower-better on the same logic:
#: ``steady_obs_*`` (obs-ON compiled orchestration seconds and the
#: obs-ON/obs-OFF overhead ratio — THE "tracing never de-optimizes
#: the hot path" budget, already covered by ``steady_``)
#: and ``ledger_*`` (bytes appended to the per-rank binary ring per
#: observed compiled fire — a grown record means the fixed-size
#: fire-path write got heavier).
#: The native_wire suite's lines split by unit: ``wire_native_p2p_*``
#: bandwidths carry "GB/s" (higher-better via the unit table, which
#: is checked first), while ``wire_native_copies*`` witnesses count
#: byte-path materializations per MiB shipped — lower-better, with
#: 0.0 the zero-copy target; a grown count means an array
#: started taking the staged/fallback copy path again.
#: The native telemetry lines follow suit: ``wire_native_stall_*``
#: (full/empty-ring stall counts and cumulative blocked seconds from
#: the C-side counter blocks) and ``wire_native_ring_hwm_frac`` (the
#: worst ring occupancy high-water fraction) are lower-better — a
#: growth means the consumer fell behind or rings shrank into
#: backpressure. ``native_obs_overhead_*`` is the counters-always-on
#: ratio (telemetry-on p2p wall over telemetry-free
#: baseline, budget 1.05): lower-better, a grown ratio means the
#: always-on counter block started costing wall time.
#: The native_rounds suite (frozen plans lowered into the C plan
#: executor) rides the SAME two prefixes by construction:
#: ``steady_native_orch_*`` seconds (whole-fire orchestration with
#: the descriptor loop running C-side) are lower-better via
#: ``steady_``, and ``compiled_native_*`` speedups (native executor
#: over the interpreted PlannedXchg replay — the >= 2x factor at
#: <= 256 KiB) are higher-better via
#: ``compiled_``; a shrunk ratio means Python crept back into the
#: per-round byte path.
METRIC_LOWER_BETTER_PREFIXES = ("ft_", "ledger_", "sentinel_", "sim_",
                                "steady_", "tenant_",
                                "wire_native_copies",
                                "wire_native_stall",
                                "wire_native_ring_hwm_frac",
                                "native_obs_overhead")

DEFAULT_SIGMA = 4.0
#: relative noise floor: the bench's own ceiling docs put single-run
#: wobble at ±20%, so no fit may claim a tighter band than this
DEFAULT_REL_FLOOR = 0.25
#: ...except the "sim" tier: fleet-simulator lines are deterministic
#: replays (bit-identical history, MAD = 0), so the wall-clock wobble
#: floor would silently pass schedule regressions up to 25% (8 -> 10
#: recursive-doubling rounds). A 2% floor tolerates float drift
#: across numpy versions while tripping on any real round/byte change
SIM_TIER = "sim"
SIM_REL_FLOOR = 0.02
DEFAULT_MIN_ROUNDS = 3


def _direction(unit: Optional[str],
               metric: Optional[str] = None) -> Optional[int]:
    """+1 = higher is better, -1 = lower is better, None = no gate."""
    if unit is not None:
        if unit in HIGHER_BETTER or unit.startswith("x_"):
            return 1
        if unit in LOWER_BETTER:
            return -1
    if metric and any(metric.startswith(p)
                      for p in METRIC_HIGHER_BETTER_PREFIXES):
        return 1
    if metric and any(metric.startswith(p)
                      for p in METRIC_LOWER_BETTER_PREFIXES):
        return -1
    return None


def line_tier(line: Dict[str, Any]) -> str:
    """The comparability tier of one metric line. ``tier_label`` is
    authoritative (bench.py stamps it on every line); older rounds
    only carried ``backend: cpu`` on fallback lines, so that maps to
    the loopback tier and everything else counts as tpu."""
    t = line.get("tier_label")
    if t:
        return str(t)
    return "loopback-cpu" if line.get("backend") == "cpu" else "tpu"


def gateable(line: Dict[str, Any]) -> bool:
    """Only clean, complete, direction-known lines feed the fit/gate."""
    if not isinstance(line, dict) or not line.get("metric"):
        return False
    if line.get("metric") in ("bench_error", "bench_gate"):
        return False
    v = line.get("value")
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return False
    if line.get("unstable") or line.get("error") \
            or line.get("partial_rounds"):
        return False
    return _direction(line.get("unit"), line.get("metric")) is not None


def parse_round_file(path: str) -> List[Dict[str, Any]]:
    """Metric lines from one round record: a round JSON (the
    ``tail`` field holds the bench's JSONL stdout) or a plain JSONL
    file. Non-JSON lines (warnings) and event lines are skipped."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict) and isinstance(doc.get("tail"), str):
            text = doc["tail"]
        elif isinstance(doc, list):
            return [ln for ln in doc
                    if isinstance(ln, dict) and ln.get("metric")]
        elif isinstance(doc, dict) and doc.get("metric"):
            return [doc]
    except ValueError:
        pass  # plain JSONL
    lines = []
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            obj = json.loads(raw)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("metric"):
            lines.append(obj)
    return lines


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def fit_bound(history: Sequence[float], *,
              sigma: float = DEFAULT_SIGMA,
              rel_floor: float = DEFAULT_REL_FLOOR
              ) -> Tuple[float, float]:
    """(median, allowed absolute deviation) from a metric's clean
    history: ``sigma`` MAD-scales (MAD × 1.4826 ≈ a robust stddev),
    with the TOTAL band floored at ``rel_floor × |median|`` — a
    coincidentally-quiet history cannot produce a hair-trigger gate,
    and a genuinely noisy line gets the wider statistical band. With
    the defaults the band is at least ±25% (the bench's own
    session-to-session wobble) so a 2× latency regression or a halved
    bandwidth always trips while ±20% ceiling wobble never does."""
    med = _median(history)
    mad = _median([abs(v - med) for v in history])
    return med, max(sigma * mad * 1.4826, rel_floor * abs(med))


def evaluate(history_rounds: List[List[Dict[str, Any]]],
             candidate_lines: List[Dict[str, Any]], *,
             sigma: float = DEFAULT_SIGMA,
             rel_floor: float = DEFAULT_REL_FLOOR,
             min_rounds: int = DEFAULT_MIN_ROUNDS) -> Dict[str, Any]:
    """Gate one candidate round against the history. Returns
    ``{"checked", "skipped", "regressions": [...], "lines": [...]}``;
    a regression entry names the metric, the fitted bound, and how far
    past it the candidate landed."""
    hist: Dict[Tuple[str, str], List[float]] = {}
    for rnd in history_rounds:
        for ln in rnd:
            if gateable(ln):
                hist.setdefault((ln["metric"], line_tier(ln)),
                                []).append(float(ln["value"]))
    checked = 0
    skipped = 0
    regressions: List[Dict[str, Any]] = []
    detail: List[Dict[str, Any]] = []
    for ln in candidate_lines:
        if not gateable(ln):
            skipped += 1
            continue
        key = (ln["metric"], line_tier(ln))
        series = hist.get(key, [])
        if len(series) < min_rounds:
            skipped += 1
            detail.append({"metric": key[0], "tier": key[1],
                           "status": "no-history",
                           "rounds": len(series)})
            continue
        med, dev = fit_bound(
            series, sigma=sigma,
            rel_floor=min(rel_floor, SIM_REL_FLOOR)
            if key[1] == SIM_TIER else rel_floor)
        v = float(ln["value"])
        direction = _direction(ln.get("unit"), ln.get("metric"))
        checked += 1
        if direction > 0:
            bound, bad = med - dev, v < med - dev
        else:
            bound, bad = med + dev, v > med + dev
        entry = {"metric": key[0], "tier": key[1], "value": v,
                 "median": round(med, 6), "bound": round(bound, 6),
                 "unit": ln.get("unit"), "rounds": len(series),
                 "status": "REGRESSION" if bad else "ok"}
        detail.append(entry)
        if bad:
            regressions.append(entry)
    return {"checked": checked, "skipped": skipped,
            "regressions": regressions, "lines": detail}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-bench-gate",
        description="Fail (exit != 0) when the newest bench round "
                    "regresses past fitted noise bounds of the "
                    "BENCH_r*.json history")
    ap.add_argument("files", nargs="*",
                    help="round records, oldest..newest (default: "
                         "./BENCH_r*.json sorted by name)")
    ap.add_argument("--candidate", default=None,
                    help="gate this file instead of the newest "
                         "history round (e.g. a fresh bench JSONL)")
    ap.add_argument("--sigma", type=float, default=DEFAULT_SIGMA,
                    help=f"bound width in MAD-scales (default "
                         f"{DEFAULT_SIGMA})")
    ap.add_argument("--rel-floor", type=float,
                    default=DEFAULT_REL_FLOOR,
                    help="minimum relative noise band (default "
                         f"{DEFAULT_REL_FLOOR} — the bench's own "
                         "ceiling wobble)")
    ap.add_argument("--min-rounds", type=int,
                    default=DEFAULT_MIN_ROUNDS,
                    help="history points required before a metric is "
                         f"gated (default {DEFAULT_MIN_ROUNDS})")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable verdict on stdout")
    args = ap.parse_args(argv)

    files = args.files or sorted(glob.glob("BENCH_r*.json"))
    if not files:
        print("tpu-bench-gate: no round records given and no "
              "./BENCH_r*.json found", file=sys.stderr)
        return 2
    files = sorted(files)
    if args.candidate is not None:
        history, cand_path = files, args.candidate
    else:
        if len(files) < 2:
            print("tpu-bench-gate: need at least 2 rounds (history + "
                  "candidate)", file=sys.stderr)
            return 2
        history, cand_path = files[:-1], files[-1]
    rounds = [parse_round_file(p) for p in history]
    cand = parse_round_file(cand_path)
    verdict = evaluate(rounds, cand, sigma=args.sigma,
                       rel_floor=args.rel_floor,
                       min_rounds=args.min_rounds)
    if args.json:
        print(json.dumps(verdict, indent=2))
    else:
        print(f"tpu-bench-gate: {len(history)} history round(s), "
              f"candidate {os.path.basename(cand_path)}: "
              f"{verdict['checked']} line(s) gated, "
              f"{verdict['skipped']} skipped")
        for e in verdict["lines"]:
            if e.get("status") == "no-history":
                continue
            mark = "FAIL" if e["status"] == "REGRESSION" else "  ok"
            print(f"  {mark} {e['metric']} [{e['tier']}]: "
                  f"{e['value']:g} {e['unit']} vs median "
                  f"{e['median']:g} (bound {e['bound']:g}, "
                  f"{e['rounds']} rounds)")
        if verdict["regressions"]:
            print(f"tpu-bench-gate: {len(verdict['regressions'])} "
                  "REGRESSION(S) past fitted noise bounds")
    return 1 if verdict["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
