"""tpu-migrate — proactive process migration (the ``orte-migrate``
analogue, ``orte/tools/orte-migrate/orte-migrate.c``; counterpart of
``ompi_release_tpu/tools/tpu_migrate.py``).

Asks a RUNNING job's HNP to evacuate a host: every rank mapped there
is terminated, remapped to a surviving slot (the host stays excluded
for future failure-respawns too), and respawned; each moved app
resumes from its last committed checkpoint via its own
``ft.run_with_restart`` / ``Checkpointer`` logic — the same
restart-from-checkpoint contract failure recovery uses.  Where the
reference pairs orte-migrate with an on-demand snapc global snapshot,
this framework's apps checkpoint on their own cadence, so migration
recomputes work since the last commit (stated, not hidden).

Usage::

    python -m ompi_release_tpu_torch.tools.tpu_migrate --off HOSTNAME \
        [--hnp H:P | --pid LAUNCHER_PID]

Without ``--hnp``/``--pid`` the session directory must hold exactly
one live job (same discovery as tpu-ps: ``tpu_ps.discover_jobs`` reads
the contact files tpurun writes).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from typing import Dict, List, Optional

from ..native import OobEndpoint
from ..runtime.coordinator import TAG_MIGRATE
from ..utils.errors import MPIError
from .tpu_ps import discover_jobs


def request_migration(host: str, port: int, off: str,
                      timeout_ms: int = 30_000,
                      secret: Optional[str] = None) -> Dict:
    """One-shot TAG_MIGRATE round trip (high random client id — same
    collision discipline as the ps/name-server clients)."""
    ep = OobEndpoint(random.randrange(1 << 20, 1 << 30),
                     secret=secret.encode() if secret else None)
    try:
        ep.connect(0, host, int(port))
        ep.send(0, TAG_MIGRATE, json.dumps({"off": off}).encode())
        _, _, raw = ep.recv(tag=TAG_MIGRATE, timeout_ms=timeout_ms)
        return json.loads(raw)
    finally:
        ep.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-migrate",
        description="Evacuate a host of a live tpurun job "
                    "(orte-migrate analogue)")
    ap.add_argument("--off", required=True,
                    help="hostname to evacuate (as it appears in the "
                         "job's allocation)")
    ap.add_argument("--hnp", default=None,
                    help="target job's HNP at host:port (supply its "
                         "control-plane secret via --secret-file or "
                         "the OMPITPU_JOB_SECRET env var)")
    ap.add_argument("--secret-file", default=None,
                    help="file holding the target job's control-plane "
                         "secret (for --hnp; session-dir discovery "
                         "reads it from the contact file)")
    ap.add_argument("--pid", type=int, default=None,
                    help="target job by launcher pid (session-dir "
                         "discovery)")
    args = ap.parse_args(argv)

    secret = None
    if args.hnp:
        host, port = args.hnp.rsplit(":", 1)
        port = int(port)
        if args.secret_file:
            with open(args.secret_file) as f:
                secret = f.read().strip()
    else:
        jobs = discover_jobs()
        if args.pid is not None:
            jobs = [j for j in jobs if int(j.get("pid", -1)) == args.pid]
        if not jobs:
            print("no matching live tpurun job found", file=sys.stderr)
            return 1
        if len(jobs) > 1:
            print(f"{len(jobs)} live jobs; pick one with --pid or "
                  "--hnp:", file=sys.stderr)
            for j in jobs:
                print(f"  pid {j['pid']}  {j['host']}:{j['port']}  "
                      f"n={j['n']}", file=sys.stderr)
            return 1
        host, port = jobs[0]["host"], int(jobs[0]["port"])
        secret = jobs[0].get("secret")

    try:
        reply = request_migration(host, port, args.off, secret=secret)
    except (MPIError, OSError) as e:
        print(f"migration request failed: {e}", file=sys.stderr)
        return 1
    if reply.get("ok"):
        ranks = ", ".join(map(str, reply.get("ranks", [])))
        print(f"migrating rank(s) {ranks} off {reply.get('off')}")
        if reply.get("skipped"):
            sk = ", ".join(map(str, reply["skipped"]))
            print(f"warning: rank(s) {sk} skipped ({reply.get('note')})",
                  file=sys.stderr)
        return 0
    print(f"migration refused: {reply.get('error')}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
