"""tpu-ps / tpu-top — live job monitoring (the ``orte-ps`` /
``orte-top`` analogue, ``orte/tools/orte-ps/orte-ps.c`` and
``orte/tools/orte-top/orte-top.c``).

Discovery follows the reference's session-dir mechanism: every running
``tpurun`` writes a contact file under the per-user session directory
(``tpurun.SESSION_DIR``); ``tpu-ps`` lists those jobs (skipping stale
files whose launcher pid is gone) and queries each HNP's TAG_PS
responder for the live snapshot — per-rank pid, proc state, vmsize/rss
(piggybacked on heartbeats by ``sensor_resusage``-style sampling), and
heartbeat age. ``tpu-top`` is the same query on a refresh loop.

Usage::

    python -m ompi_release_tpu_torch.tools.tpu_ps            # all local jobs
    python -m ompi_release_tpu_torch.tools.tpu_ps --hnp H:P  # one job direct
    python -m ompi_release_tpu_torch.tools.tpu_top [-d SECS]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from typing import Dict, List, Optional

from ..native import OobEndpoint
from ..runtime.coordinator import TAG_PS
from ..utils.errors import ErrorCode, MPIError
from ..utils.procutil import pid_alive as _pid_alive


class PsClient:
    """One-shot snapshot query against a job's HNP (high random client
    id, like the cross-job NameClient — ps clients from any job must
    not collide with worker ids)."""

    def __init__(self, host: str, port: int,
                 secret: Optional[str] = None) -> None:
        self.ep = OobEndpoint(
            random.randrange(1 << 20, 1 << 30),
            secret=secret.encode() if secret else None,
        )
        self.ep.connect(0, host, int(port))

    def query(self, timeout_ms: int = 5_000) -> Dict:
        self.ep.send(0, TAG_PS, b"")
        _, _, raw = self.ep.recv(tag=TAG_PS, timeout_ms=timeout_ms)
        return json.loads(raw)

    def close(self) -> None:
        self.ep.close()


def discover_jobs() -> List[Dict]:
    """Live jobs from the session contact files (stale files — dead
    launcher pids — are reaped here, the orte-clean-lite duty)."""
    from .tpurun import SESSION_DIR

    jobs = []
    if not os.path.isdir(SESSION_DIR):
        return jobs
    for name in sorted(os.listdir(SESSION_DIR)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(SESSION_DIR, name)
        try:
            with open(path) as f:
                info = json.load(f)
        except (OSError, ValueError):
            continue
        pid = info.get("pid") if isinstance(info, dict) else None
        # bool rejection lives in pid_alive (JSON true is an int)
        if not isinstance(pid, int) or not _pid_alive(pid):
            try:
                os.unlink(path)  # stale: launcher is gone
            except OSError:
                pass
            continue
        jobs.append(info)
    return jobs


def _fmt_bytes(n) -> str:
    if not n:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.0f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def render_job(info: Dict, snap: Optional[Dict]) -> str:
    lines = [
        f"Job (tpurun pid {info.get('pid', '?')}) "
        f"n={info.get('n', '?')} "
        f"cmd={' '.join(info.get('argv', []))[:60]}"
    ]
    if snap is None:
        lines.append("  (HNP did not answer the snapshot query)")
        return "\n".join(lines)
    states = snap.get("proc_states", {})
    lines.append(
        f"  {'rank':>4} {'pid':>8} {'state':<16} {'rss':>9} "
        f"{'vmsize':>9} {'beat-age':>8}"
    )
    for nid_s, w in sorted(snap.get("workers", {}).items(),
                           key=lambda kv: int(kv[0])):
        nid = int(nid_s)
        age = w.get("beat_age_s")
        lines.append(
            f"  {nid - 1:>4} {w.get('pid', '-')!s:>8} "
            f"{states.get(nid_s, '?'):<16} "
            f"{_fmt_bytes(w.get('rss')):>9} "
            f"{_fmt_bytes(w.get('vmsize')):>9} "
            f"{(f'{age:.1f}s' if age is not None else '-'):>8}"
        )
    return "\n".join(lines)


def snapshot_all(hnp: Optional[str] = None,
                 secret_file: Optional[str] = None) -> List[str]:
    """Rendered snapshots of every target job."""
    out = []
    if hnp:
        host, port = hnp.rsplit(":", 1)
        target = {"host": host, "port": int(port), "pid": "?",
                  "argv": [], "n": "?"}
        if secret_file:
            with open(secret_file) as f:
                target["secret"] = f.read().strip()
        targets = [target]
    else:
        targets = discover_jobs()
    for info in targets:
        client = None
        snap = None
        try:
            client = PsClient(info["host"], info["port"],
                              secret=info.get("secret"))
            snap = client.query()
        except (MPIError, OSError):
            snap = None
        finally:
            if client is not None:
                client.close()
        out.append(render_job(info, snap))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ps",
        description="List live tpurun jobs and their per-rank state "
                    "(orte-ps analogue)")
    ap.add_argument("--hnp", default=None,
                    help="query one job directly at host:port instead "
                         "of discovering via the session dir (the "
                         "job's control plane is authenticated: supply "
                         "its secret via --secret-file or the "
                         "OMPITPU_JOB_SECRET env var)")
    ap.add_argument("--secret-file", default=None,
                    help="file holding the target job's control-plane "
                         "secret (for --hnp; session-dir discovery "
                         "reads it from the contact file)")
    args = ap.parse_args(argv)
    snaps = snapshot_all(args.hnp, secret_file=args.secret_file)
    if not snaps:
        print("no live tpurun jobs found")
        return 0
    print("\n\n".join(snaps))
    return 0


def main_top(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-top",
        description="Continuously display live tpurun jobs "
                    "(orte-top analogue)")
    ap.add_argument("--hnp", default=None)
    ap.add_argument("-d", "--delay", type=float, default=2.0,
                    help="refresh interval in seconds")
    ap.add_argument("--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = until SIGINT)")
    args = ap.parse_args(argv)
    i = 0
    try:
        while True:
            snaps = snapshot_all(args.hnp)
            sys.stdout.write("\x1b[2J\x1b[H" if sys.stdout.isatty()
                             else "")
            print(time.strftime("tpu-top  %H:%M:%S"))
            print("\n\n".join(snaps) if snaps
                  else "no live tpurun jobs found")
            sys.stdout.flush()
            i += 1
            if args.iterations and i >= args.iterations:
                return 0
            time.sleep(args.delay)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
