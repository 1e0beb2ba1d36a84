"""tpu-doctor — postmortem & distributed-tracing workbench.

The operator-facing end of the observability plane's cross-process
layer (``obs/doctor.py``): collect per-rank journal dumps, merge them
into ONE clock-aligned Perfetto trace with send→recv flow arrows, and
print the critical-path / rank-skew report naming the slowest rank
per collective round.

Usage::

    # ranks ran with --mca obs_enable 1 --mca obs_dump_dir DIR
    python -m ompi_release_tpu_torch.tools.tpu_doctor merge DIR -o trace.json
    python -m ompi_release_tpu_torch.tools.tpu_doctor report DIR
    python -m ompi_release_tpu_torch.tools.tpu_doctor postmortem DIR

    # ranks ran with --mca obs_sentinel 1: align per-comm collective
    # call signatures across ranks and name the first desync
    python -m ompi_release_tpu_torch.tools.tpu_doctor contracts DIR

    # fetch a live process's journal over the tpu-server journal RPC
    python -m ompi_release_tpu_torch.tools.tpu_doctor collect host:port -o DIR

``merge`` also accepts a directory holding only ``postmortem-*.json``
files (a hung job's flight-recorder output): the journal tails inside
are merged the same way. Load the trace at ui.perfetto.dev or
chrome://tracing; flow arrows join each wire send span to its matching
recv on the peer rank.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

from ..obs import doctor as _doctor


def _cmd_merge(args) -> int:
    dumps = _doctor.load_dir(args.dir)
    trace = _doctor.merge(dumps)
    out = args.out or os.path.join(args.dir, "merged-trace.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    od = trace["otherData"]
    print(f"tpu-doctor: merged {od['processes']} rank journal(s), "
          f"{od['spans']} spans, {od['flows']} flow arrow(s) "
          f"({od['cross_process_flows']} cross-process) -> {out}")
    print("open in ui.perfetto.dev or chrome://tracing")
    return 0


def _cmd_report(args) -> int:
    dumps = _doctor.load_dir(args.dir)
    # series dumps ride the same obs_dump_dir: when present, the
    # report annotates its critical path with sampled rates
    try:
        series = _doctor.load_series_dir(args.dir)
    except (OSError, ValueError):
        series = []
    text, _ = _doctor.skew_report(dumps, series=series or None)
    print(text)
    return 0


def _cmd_series(args) -> int:
    """Merge per-rank series dumps into ONE clock-corrected fleet
    series — JSONL (one corrected point per line) or OpenMetrics."""
    from ..obs import export as _export

    docs = _doctor.load_series_dir(args.dir)
    if not docs:
        print(f"no series-p*.jsonl under {args.dir} (set --mca "
              "obs_sample_interval > 0 and obs_dump_dir)",
              file=sys.stderr)
        return 1
    merged = _doctor.merge_series(docs)
    if args.openmetrics:
        # ONE exposition over the merged, clock-corrected points:
        # concatenating per-process pages would repeat/interleave
        # family TYPE lines, which the OpenMetrics spec forbids
        text = _export.openmetrics_series(
            [dict(p, t=p["ts"]) for p in merged])
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        else:
            print(text, end="")
    else:
        out = args.out or os.path.join(args.dir, "merged-series.jsonl")
        with open(out, "w") as f:
            for p in merged:
                f.write(json.dumps(p) + "\n")
        print(f"tpu-doctor: merged {len(docs)} rank series "
              f"({len(merged)} clock-corrected points) -> {out}")
    return 0


def _cmd_contracts(args) -> int:
    """Collective-contract alignment: per-comm posting sequences of
    sentinel call signatures, merged across ranks; exit 3 when a
    divergence was found (0 = all call streams agree)."""
    dumps = _doctor.load_dir(args.dir)
    text, data = _doctor.contract_report(dumps, directory=args.dir)
    print(text)
    return 3 if data["divergences"] else 0


def _cmd_postmortem(args) -> int:
    """Summarize every postmortem in a directory: the hang story."""
    paths = sorted(glob.glob(os.path.join(args.dir, "postmortem-*.json")))
    if not paths:
        print(f"no postmortem-*.json under {args.dir}", file=sys.stderr)
        return 1
    for p in paths:
        with open(p) as f:
            pm = json.load(f)
        rank = pm.get("rank", {})
        print(f"{os.path.basename(p)}: reason={pm.get('reason')} "
              f"proc={rank.get('pidx', '?')} pid={rank.get('pid')}")
        for st in pm.get("stalled", []) or []:
            info = st.get("info") or {}
            awaiting = (info.get("awaiting_ranks")
                        or info.get("awaiting_procs") or "?")
            print(f"  STALLED {st.get('op')} (comm {st.get('comm')}): "
                  f"waited {st.get('waited_s')}s, awaiting {awaiting}")
        rounds = pm.get("hier_rounds")
        if isinstance(rounds, dict):
            for cid, st in rounds.items():
                print(f"  round: comm {cid} op={st.get('op')} "
                      f"#{st.get('round')} awaiting ranks "
                      f"{st.get('awaiting_ranks')}")
        mq = pm.get("msg_queues")
        if isinstance(mq, list):
            for c in mq:
                unex, posted = c.get("unexpected", []), c.get("posted", [])
                if unex or posted:
                    print(f"  queues: {c.get('comm')} "
                          f"{len(unex)} unexpected, {len(posted)} posted")
    return 0


def _cmd_collect(args) -> int:
    from .tpu_server import NameClient

    host, _, port = args.server.rpartition(":")
    if not host:
        print("collect needs host:port", file=sys.stderr)
        return 2
    out_dir = args.out or "."
    os.makedirs(out_dir, exist_ok=True)
    client = NameClient(host, int(port))
    try:
        dump = client.journal()
        pidx = dump.get("meta", {}).get("pidx", 0)
        path = os.path.join(out_dir, f"journal-p{pidx}.json")
        with open(path, "w") as f:
            json.dump(dump, f)
        print(f"tpu-doctor: {len(dump.get('spans', []))} spans from "
              f"{args.server} -> {path}")
        if args.metrics:
            mpath = os.path.join(out_dir, f"metrics-p{pidx}.prom")
            with open(mpath, "w") as f:
                f.write(client.metrics())
            print(f"tpu-doctor: pvar exposition -> {mpath}")
    finally:
        client.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-doctor",
        description="Merge per-rank obs journals into one Perfetto "
                    "trace, explain hangs from postmortems, and rank "
                    "the slow ranks")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merge", help="merge rank dumps into one "
                                     "Perfetto trace with flow arrows")
    p.add_argument("dir", help="directory of journal-p*.json (or "
                               "postmortem-*.json) dumps")
    p.add_argument("-o", "--out", default=None,
                   help="output trace path (default: "
                        "<dir>/merged-trace.json)")
    p.set_defaults(fn=_cmd_merge)

    p = sub.add_parser("report", help="critical-path + rank-skew "
                                      "report per collective round "
                                      "(annotated with sampled rates "
                                      "when series-p*.jsonl exist)")
    p.add_argument("dir")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("series", help="merge per-rank continuous "
                                      "series dumps into one "
                                      "clock-corrected fleet series")
    p.add_argument("dir", help="directory of series-p*.jsonl dumps "
                               "(obs_sample_interval + obs_dump_dir)")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: "
                        "<dir>/merged-series.jsonl)")
    p.add_argument("--openmetrics", action="store_true",
                   help="emit OpenMetrics-with-timestamps text "
                        "instead of JSONL")
    p.set_defaults(fn=_cmd_series)

    p = sub.add_parser(
        "contracts",
        help="align per-comm collective call signatures "
             "(obs_sentinel >= 1) across rank journals or watchdog "
             "postmortems and name the first desync: missing "
             "participant, op/dtype/count mismatch, posting-order "
             "swap, or epoch skew — with both call sites (exit 3 on "
             "divergence)")
    p.add_argument("dir", help="directory of journal-p*.json and/or "
                               "postmortem-*.json dumps")
    p.set_defaults(fn=_cmd_contracts)

    p = sub.add_parser("postmortem", help="summarize flight-recorder "
                                          "dumps: stuck ops + waiting "
                                          "ranks")
    p.add_argument("dir")
    p.set_defaults(fn=_cmd_postmortem)

    p = sub.add_parser("collect", help="fetch a live process's journal "
                                       "over the tpu-server RPC")
    p.add_argument("server", help="host:port of a tpu-server (or any "
                                  "process running MetricsPubsubTable)")
    p.add_argument("-o", "--out", default=None,
                   help="output directory (default: .)")
    p.add_argument("--metrics", action="store_true",
                   help="also save the Prometheus pvar exposition")
    p.set_defaults(fn=_cmd_collect)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-doctor: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # `tpu-doctor ... | head` closes our stdout mid-print: the
        # Unix-polite exit, not a traceback
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
