"""tpu-top — live fleet dashboard (``orte-top`` analogue, grown up).

Four modes:

- ``--tenants HOST:PORT``: the multi-tenant service plane's view —
  poll a ``tpu_serviced`` daemon's TAG_TENANTS RPC and render who is
  burning the fabric: per-tenant coll/s, MB/s, lane share, HOL wait
  (self-reported via lease renewals), lease/beat ages, capacity in
  use, and recent evictions with their reasons.

- default: tpu_ps's per-rank process snapshot on a refresh loop
  (``python -m ompi_release_tpu_torch.tools.tpu_top [-d SECS]``).
- ``--metrics HOST:PORT``: poll a ``tpu_server``'s metrics RPC and
  render the live Prometheus pvar page. Survives server restarts: a
  failed poll prints a stale-data marker and reconnects with backoff
  instead of exiting.
- ``--fleet [HOST:PORT]`` / ``--fleet-from DIR``: the continuous
  metrics plane's dashboard. Renders one row per controller process
  from the sampler's time-series points — collective rate, bytes/s,
  latency percentiles (from the ``coll_*_latency`` histogram pvar
  deltas), mean arrival skew, the compiled-fire ratio (``comp%``,
  from the ``coll_compiled_cache_hits`` aggregate deltas — how much
  of the window's traffic replayed frozen plans), and inline STALL /
  DESYNC / DARK / STALE flags (DESYNC counts the contract sentinel's
  detected cross-rank collective mismatches, ``sentinel_mismatches``
  deltas; DARK marks a rank whose compiled fires emitted neither
  spans nor flight-recorder ledger records — observed traffic that
  tracing cannot see) — either
  live from a job HNP's TAG_SERIES store (discovered via the session
  dir when no target is given) or offline from ``series-p*.jsonl``
  dumps. The refresh loop reconnects with backoff and marks rows
  stale rather than dying with the server.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from typing import Any, Dict, List, Optional

#: a proc whose newest push/sample is older than this many refresh
#: delays is flagged STALE (its rank may be hung — or the sampler off)
STALE_FACTOR = 3.0


# ---------------------------------------------------------------------------
# fleet summarization (pure — the testable core)
# ---------------------------------------------------------------------------


def summarize_points(points: List[Dict[str, Any]],
                     window_s: float = 15.0,
                     now: Optional[float] = None) -> Dict[str, Any]:
    """Fold one process's sampler points (newest ``window_s`` seconds
    of them) into the dashboard row: collective ops/s and MB/s from
    the per-cid ``coll_ops``/``coll_bytes`` deltas, p50/p99 latency
    from the ``coll_*_latency`` histogram delta buckets, mean skew
    from ``coll_*_skew_seconds``, a stall flag from
    ``obs_stalls_detected`` deltas, and a desync flag from the
    contract sentinel's ``sentinel_mismatches`` deltas.

    The compiled steady state is first-class: the compiled-fire ratio
    folds from the ``coll_compiled_cache_hits`` aggregate deltas
    (sum = frozen-plan replays, count = total fires through the plan
    layer), and a rank whose compiled traffic left NO trace — plan
    replays in the window but neither per-cid ``coll_ops`` span folds
    nor flight-recorder ``ledger_records`` — comes back ``dark``:
    obs is on (the sampler only runs under obs) yet the hot path is
    invisible, exactly the de-optimization regression this plane
    exists to catch.

    The native wire gets the same treatment one layer down: staged
    throughput splits into its native share (``wire_native_bytes``
    deltas over the ``btl_dcn_staged_bytes`` total), and a rank moving
    native frames while NONE of the C-side telemetry series
    (``wire_native_ring_stalls`` / ``wire_native_stall_seconds`` /
    ``wire_native_ring_hwm_frac``, folded from the ring-header counter
    blocks) ever produced a point comes back ``dark_native`` — the
    signature of a stale ``libompitpu_native.so`` predating the
    telemetry block. ``now`` defaults to the newest point's time
    (dump replay); pass the live clock for live feeds."""
    from ..obs.sampler import percentile

    if not points:
        return {"ops_s": None, "mb_s": None, "p50_ms": None,
                "p99_ms": None, "skew_ms": None, "stalls": 0,
                "desyncs": 0, "cids": [], "age_s": None,
                "window_s": 0.0, "compiled_frac": None,
                "ledger_records": 0, "dark": False,
                "native_mb_s": None, "staged_mb_s": None,
                "native_frac": None, "dark_native": False}
    ts = [float(p["t"]) for p in points]
    t_new = max(ts)
    if now is None:
        now = t_new
    lo = t_new - window_s
    ops = bytes_ = 0.0
    lat_buckets: Dict[float, float] = {}
    skew_sum = skew_count = 0.0
    stalls = desyncs = 0.0
    plan_hits = plan_fires = ledger_recs = 0.0
    native_bytes = native_frames = wire_bytes = 0.0
    native_tele = 0
    cids = set()
    t_used = []
    for p in points:
        t = float(p["t"])
        if t < lo:
            continue
        name = str(p.get("name", ""))
        v = p.get("v")
        t_used.append(t)
        cid = int(p.get("cid", -1))
        if name == "coll_ops":
            ops += float(v or 0)
            cids.add(cid)
        elif name == "coll_bytes":
            bytes_ += float(v or 0)
        elif name.endswith("_latency") and isinstance(v, dict):
            for ub, c in (v.get("buckets") or {}).items():
                lat_buckets[float(ub)] = (lat_buckets.get(float(ub), 0.0)
                                          + float(c))
        elif name.endswith("_skew_seconds") and isinstance(v, dict):
            skew_sum += float(v.get("sum", 0.0))
            skew_count += float(v.get("count", 0.0))
        elif name == "obs_stalls_detected":
            stalls += float(v or 0)
        elif name == "sentinel_mismatches":
            desyncs += float(v or 0)
        elif name == "coll_compiled_cache_hits" and isinstance(v, dict):
            plan_hits += float(v.get("sum", 0.0) or 0.0)
            plan_fires += float(v.get("count", 0.0) or 0.0)
        elif name == "ledger_records":
            ledger_recs += float(v or 0)
        elif name == "wire_native_bytes":
            native_bytes += float(v or 0)
        elif name == "wire_native_frames":
            native_frames += float(v or 0)
        elif name == "btl_dcn_staged_bytes":
            wire_bytes += float(v or 0)
        elif name in ("wire_native_ring_stalls",
                      "wire_native_stall_seconds",
                      "wire_native_ring_hwm_frac"):
            native_tele += 1
    # a window holding a single sampler tick has NO measurable span —
    # rates are unknown then, not "whatever 1 ms would imply" (a lone
    # 10-op tick must render '-', never 10000 coll/s)
    distinct = sorted(set(t_used))
    window = (distinct[-1] - distinct[0]
              if len(distinct) >= 2 else None)
    p50 = percentile(lat_buckets, 0.5)
    p99 = percentile(lat_buckets, 0.99)
    return {
        "ops_s": ops / window if window else None,
        "mb_s": bytes_ / window / 1e6 if window else None,
        "p50_ms": p50 * 1e3 if p50 is not None else None,
        "p99_ms": p99 * 1e3 if p99 is not None else None,
        "skew_ms": (skew_sum / skew_count * 1e3) if skew_count else None,
        "stalls": int(stalls),
        "desyncs": int(desyncs),
        "cids": sorted(c for c in cids if c >= 0),
        "age_s": max(now - t_new, 0.0),
        "window_s": window or 0.0,
        "compiled_frac": (plan_hits / plan_fires
                          if plan_fires else None),
        "ledger_records": int(ledger_recs),
        "dark": bool(plan_hits > 0 and ops == 0
                     and ledger_recs == 0),
        "native_mb_s": native_bytes / window / 1e6 if window else None,
        "staged_mb_s": (max(0.0, wire_bytes - native_bytes)
                        / window / 1e6 if window else None),
        "native_frac": (min(1.0, native_bytes / wire_bytes)
                        if wire_bytes else None),
        "dark_native": bool(native_frames > 0 and native_tele == 0),
    }


def _fmt(v, spec: str, dash: str = "-") -> str:
    return dash if v is None else format(v, spec)


def render_fleet(docs: List[Dict[str, Any]], window_s: float = 15.0,
                 stale_after_s: Optional[float] = None) -> str:
    """The per-rank dashboard table from per-process series docs
    (``{"meta": {...}, "points": [...]}`` — offline dumps and the
    live fleet query share this shape via
    ``obs.doctor.fleet_to_series_docs``)."""
    head = (f"  {'proc':>4} {'ranks':>9} {'coll/s':>8} {'MB/s':>9} "
            f"{'nwMB/s':>8} {'nat%':>5} "
            f"{'p50 ms':>8} {'p99 ms':>8} {'skew ms':>8} "
            f"{'comp%':>6} {'cids':>6} flags")
    lines = [head]
    for d in docs:
        m = d.get("meta") or {}
        pidx = int(m.get("pidx", 0))
        off0 = int(m.get("rank_offset", 0) or 0)
        n = int(m.get("local_size", 0) or 0)
        ranks = f"{off0}..{off0 + n - 1}" if n else "?"
        s = summarize_points(list(d.get("points") or ()),
                             window_s=window_s)
        flags = []
        if s["stalls"]:
            flags.append(f"STALL×{s['stalls']}")
        if s["desyncs"]:
            flags.append(f"DESYNC×{s['desyncs']}")
        if s["dark"]:
            # compiled fires in the window but zero spans AND zero
            # flight-recorder records: the hot path went invisible
            flags.append("DARK")
        if s["dark_native"]:
            # native frames moved but the C-side counter-block series
            # never produced a point: the zero-copy byte path went
            # invisible (stale .so predating the telemetry block)
            flags.append("DARK-NATIVE")
        age = m.get("push_age_s")
        if age is None:
            age = s["age_s"]
        if (stale_after_s is not None and age is not None
                and age > stale_after_s):
            flags.append(f"STALE {age:.0f}s")
        lines.append(
            f"  {pidx:>4} {ranks:>9} "
            f"{_fmt(s['ops_s'], '8.1f'):>8} "
            f"{_fmt(s['mb_s'], '9.2f'):>9} "
            f"{_fmt(s['native_mb_s'], '8.2f'):>8} "
            f"{_fmt(s['native_frac'] * 100 if s['native_frac'] is not None else None, '5.1f'):>5} "
            f"{_fmt(s['p50_ms'], '8.3f'):>8} "
            f"{_fmt(s['p99_ms'], '8.3f'):>8} "
            f"{_fmt(s['skew_ms'], '8.3f'):>8} "
            f"{_fmt(s['compiled_frac'] * 100 if s['compiled_frac'] is not None else None, '5.1f'):>6} "
            f"{len(s['cids']):>6} {' '.join(flags)}".rstrip())
    if len(lines) == 1:
        lines.append("  (no series points yet — is obs_sample_interval "
                     "set on the job?)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# tenant view (TAG_TENANTS against a tpu-serviced daemon)
# ---------------------------------------------------------------------------


def render_tenants(doc: Dict[str, Any]) -> str:
    """The per-tenant fabric table from a daemon's TAG_TENANTS doc
    (``service.daemon.ServiceClient.tenants()``): who is burning the
    fabric — per-tenant collective rate, MB/s, lane share, HOL wait
    (all self-reported via lease-renewal stats), plus lease age and
    state. Evicted tenants render below the live ones with the
    eviction reason — the FT-isolation episode stays visible."""
    cap = doc.get("capacity") or {}
    head = (f"  {'tid':>3} {'tenant':>14} {'qos':>11} {'ranks':>5} "
            f"{'lanes':>5} {'coll/s':>8} {'MB/s':>9} {'lane%':>6} "
            f"{'hol ms':>7} {'beat s':>6} state")
    lines = [
        f"  capacity: {cap.get('used_ranks', 0)}/{cap.get('ranks', '?')}"
        f" ranks, {cap.get('used_lanes', 0)}/{cap.get('lanes', '?')}"
        " lanes in use",
        head,
    ]

    def row(t: Dict[str, Any]) -> str:
        s = t.get("stats") or {}
        share = s.get("lane_share")
        hol = s.get("hol_wait_s")
        state = t.get("state", "?")
        if state == "evicted" and t.get("evict_reason"):
            state = f"evicted ({t['evict_reason']})"
        return (f"  {t.get('tid', '?'):>3} "
                f"{str(t.get('name', '?'))[:14]:>14} "
                f"{str(t.get('qos', '-'))[:11]:>11} "
                f"{t.get('ranks', 0):>5} {t.get('lanes', 0):>5} "
                f"{_fmt(s.get('coll_s'), '8.1f'):>8} "
                f"{_fmt(s.get('mb_s'), '9.2f'):>9} "
                f"{_fmt(share * 100 if share is not None else None, '5.1f'):>6} "
                f"{_fmt(hol * 1e3 if hol is not None else None, '7.2f'):>7} "
                f"{_fmt(t.get('beat_age_s'), '6.1f'):>6} {state}")

    tenants = list(doc.get("tenants") or ())
    for t in tenants:
        lines.append(row(t))
    if not tenants:
        lines.append("  (no live tenants)")
    evicted = list(doc.get("evicted") or ())
    if evicted:
        lines.append("  -- recent evictions --")
        for t in evicted:
            lines.append(row(t))
    return "\n".join(lines)


def _tenants_loop(target: str, delay: float, iterations: int) -> int:
    """Poll a tpu-serviced daemon's TAG_TENANTS view on a loop, with
    the shared reconnect-with-backoff contract (see
    :func:`_client_poll_loop`)."""
    from ..service.daemon import ServiceClient

    return _client_poll_loop(
        "tenants", "tenants", target, delay, iterations,
        ServiceClient, lambda c: render_tenants(c.tenants()))


# ---------------------------------------------------------------------------
# live fleet query (TAG_SERIES against a job HNP)
# ---------------------------------------------------------------------------


class FleetClient:
    """One-shot fleet-series query against a job's HNP (high random
    client id, like PsClient — must not collide with worker ids)."""

    def __init__(self, host: str, port: int,
                 secret: Optional[str] = None) -> None:
        from ..native import OobEndpoint

        self.ep = OobEndpoint(
            random.randrange(1 << 20, 1 << 30),
            secret=secret.encode() if secret else None,
        )
        self.ep.connect(0, host, int(port))

    def query(self, timeout_ms: int = 5_000) -> Dict:
        from ..runtime.coordinator import TAG_SERIES

        self.ep.send(0, TAG_SERIES, b"{}")
        _, _, raw = self.ep.recv(tag=TAG_SERIES, timeout_ms=timeout_ms)
        return json.loads(raw)

    def close(self) -> None:
        self.ep.close()


def _fleet_targets(target: Optional[str]) -> List[Dict[str, Any]]:
    if target:
        host, port_s = target.rsplit(":", 1)
        return [{"host": host, "port": int(port_s), "pid": "?"}]
    from .tpu_ps import discover_jobs

    return discover_jobs()


def _fleet_frame(target: Optional[str], window_s: float,
                 delay: float) -> str:
    """One refresh of the live fleet view: query every target job's
    HNP; a job that does not answer renders as unreachable instead of
    killing the loop (the reconnect contract)."""
    from ..obs.doctor import fleet_to_series_docs
    from ..utils.errors import MPIError

    chunks = []
    for info in _fleet_targets(target):
        label = (f"job (tpurun pid {info.get('pid', '?')}) "
                 f"@ {info.get('host')}:{info.get('port')}")
        client = None
        try:
            client = FleetClient(info["host"], info["port"],
                                 secret=info.get("secret"))
            fleet = client.query()
        except (MPIError, OSError, ValueError) as e:
            chunks.append(f"{label}\n  (HNP unreachable: {e}; "
                          "retrying next refresh)")
            continue
        finally:
            if client is not None:
                client.close()
        docs = fleet_to_series_docs(fleet)
        chunks.append(label + "\n" + render_fleet(
            docs, window_s=window_s,
            stale_after_s=STALE_FACTOR * delay))
    return ("\n\n".join(chunks) if chunks
            else "no live tpurun jobs found")


def _fleet_loop(target: Optional[str], delay: float, iterations: int,
                window_s: float) -> int:
    i = 0
    try:
        while True:
            frame = _fleet_frame(target, window_s, delay)
            sys.stdout.write("\x1b[2J\x1b[H" if sys.stdout.isatty()
                             else "")
            print("tpu-top fleet  " + time.strftime("%H:%M:%S"))
            print(frame)
            sys.stdout.flush()
            i += 1
            if iterations and i >= iterations:
                return 0
            time.sleep(delay)
    except KeyboardInterrupt:
        return 0


def fleet_from_dir(directory: str, window_s: float = 1e18) -> str:
    """One offline frame from ``series-p*.jsonl`` dumps (the whole
    sampled history by default) — the post-run view of the same table
    the live loop renders."""
    from ..obs.doctor import load_series_dir

    docs = load_series_dir(directory)
    if not docs:
        return (f"no series-p*.jsonl under {directory} (run with "
                "--mca obs_sample_interval 1 --mca obs_dump_dir DIR)")
    return render_fleet(docs, window_s=window_s)


# ---------------------------------------------------------------------------
# pvar page mode (tpu_server metrics RPC) — with reconnect
# ---------------------------------------------------------------------------


def _client_poll_loop(flag: str, label: str, target: str,
                      delay: float, iterations: int, make_client,
                      fetch) -> int:
    """THE shared poll/render driver for the client-backed modes
    (``--metrics``, ``--tenants``): parse HOST:PORT, connect on
    demand, render ``fetch(client)`` each refresh; a dead/restarted
    server does NOT end the loop — the last frame re-renders with a
    stale marker and the client reconnects with bounded exponential
    backoff. With ``iterations`` set, exits 0 iff any frame was ever
    fetched. One contract, one implementation — a backoff/exit-code
    fix lands in every mode at once."""
    from ..utils.errors import MPIError

    try:
        host, port_s = target.rsplit(":", 1)
        port = int(port_s)
    except ValueError:
        print(f"tpu-top: --{flag} wants HOST:PORT, got {target!r}",
              file=sys.stderr)
        return 2
    client = None
    last_frame: Optional[str] = None
    last_ok: Optional[float] = None
    backoff = delay
    i = 0
    try:
        while True:
            frame = None
            err = None
            try:
                if client is None:
                    client = make_client(host, port)
                frame = fetch(client)
            except (MPIError, OSError, ValueError) as e:
                err = e
                if client is not None:
                    try:
                        client.close()
                    except Exception:
                        pass
                    client = None  # reconnect fresh next round
            sys.stdout.write("\x1b[2J\x1b[H" if sys.stdout.isatty()
                             else "")
            # target stays out of the strftime format: a '%' in it
            # (IPv6 zone-id hosts) would expand or raise
            print(f"tpu-top {label} @ " + target + "  "
                  + time.strftime("%H:%M:%S"))
            if frame is not None:
                last_frame, last_ok = frame, time.monotonic()
                backoff = delay
                print(frame, end="" if frame.endswith("\n") else "\n")
            else:
                age = (time.monotonic() - last_ok
                       if last_ok is not None else None)
                print(f"  [STALE — server unreachable: {err}; "
                      + (f"showing data from {age:.0f}s ago; "
                         if age is not None else "no data yet; ")
                      + f"reconnecting in {backoff:.0f}s]")
                if last_frame is not None:
                    print(last_frame,
                          end="" if last_frame.endswith("\n")
                          else "\n")
            sys.stdout.flush()
            i += 1
            if iterations and i >= iterations:
                return 0 if frame is not None \
                    or last_frame is not None else 1
            time.sleep(backoff if frame is None else delay)
            if frame is None:
                backoff = min(backoff * 2, 30.0)
    except KeyboardInterrupt:
        return 0
    finally:
        if client is not None:
            client.close()


def _metrics_loop(target: str, delay: float, iterations: int) -> int:
    """Poll a tpu_server's Prometheus page on the shared
    reconnect-with-backoff driver."""
    from .tpu_server import NameClient

    return _client_poll_loop("metrics", "pvars", target, delay,
                             iterations, NameClient,
                             lambda c: c.metrics())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="tpu-top", add_help=False)
    ap.add_argument("--metrics", default=None,
                    help="render a tpu-server's live pvar page "
                         "(host:port) instead of job snapshots")
    ap.add_argument("--fleet", nargs="?", const="", default=None,
                    help="live per-rank collective-rate dashboard from "
                         "a job HNP's series store (host:port; no "
                         "argument = discover local jobs)")
    ap.add_argument("--fleet-from", default=None, metavar="DIR",
                    help="render one fleet frame from series-p*.jsonl "
                         "dumps in DIR (post-run view)")
    ap.add_argument("--tenants", default=None, metavar="HOST:PORT",
                    help="render a tpu-serviced daemon's per-tenant "
                         "fabric view (who is burning the fabric: "
                         "coll/s, MB/s, lane share, HOL wait, leases)")
    args, rest = ap.parse_known_args(argv)
    if args.fleet_from is not None:
        print(fleet_from_dir(args.fleet_from))
        return 0
    if args.metrics is None and args.fleet is None \
            and args.tenants is None:
        from .tpu_ps import main_top

        return main_top(rest)
    mp = argparse.ArgumentParser(
        prog="tpu-top --metrics/--fleet/--tenants")
    mp.add_argument("-d", "--delay", type=float, default=2.0,
                    help="refresh interval in seconds")
    mp.add_argument("--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = until SIGINT)")
    mp.add_argument("--window", type=float, default=15.0,
                    help="rate window in seconds (fleet mode)")
    ma = mp.parse_args(rest)
    if args.tenants is not None:
        return _tenants_loop(args.tenants, ma.delay, ma.iterations)
    if args.fleet is not None:
        return _fleet_loop(args.fleet or None, ma.delay,
                           ma.iterations, ma.window)
    return _metrics_loop(args.metrics, ma.delay, ma.iterations)


if __name__ == "__main__":
    sys.exit(main())
