"""tpu-clean — remove leftover job debris (the ``orte-clean``
analogue, ``orte/tools/orte-clean/orte-clean.c``).

What the reference's orte-clean removes — stale session directories
and orphaned daemons of dead jobs — maps here to:

* **session contact files** under ``tpurun.SESSION_DIR`` whose
  launcher pid is dead (or whose contents are unparseable debris);
* **orphaned shm handoff segments**: ShmBtl names every segment
  ``ompitpu-<creator pid>-<uuid>`` precisely so this tool can unlink
  segments whose creator died without the receiver ever mapping them
  (the sender-side TTL reaper only runs while the sender lives).
  Only regular files matching that exact name pattern are candidates;
  anything else under /dev/shm — including the session directory
  itself when ``TMPDIR=/dev/shm`` — is never touched.

Segment reaping is double-gated: creator dead AND segment older than
``--min-age`` (default 60 s). The age gate exists because ShmBtl
transfers OWNERSHIP to the receiver at announce — a sender may exit
cleanly while a live receiver is milliseconds from mapping the
segment, and creator-death alone would tear that transfer down. A
receiver that has not mapped a segment after min-age has hit its own
recv timeout long since.

Live launchers are never touched, and debris owned by OTHER users
(PermissionError on the liveness probe) is left alone.

Usage::

    python -m ompi_release_tpu_torch.tools.tpu_clean [--dry-run] [-v]
        [--min-age SECONDS]
"""

from __future__ import annotations

import argparse
import json
import os
import stat as stat_mod
import sys
import time
from typing import List, Optional, Tuple

from ..utils.procutil import pid_alive

SHM_DIR = "/dev/shm"
SHM_PREFIX = "ompitpu-"


def stale_sessions() -> List[str]:
    """Contact files whose launcher pid is dead plus unparseable
    debris (anything that cannot yield a positive int pid)."""
    from .tpurun import SESSION_DIR

    out = []
    if not os.path.isdir(SESSION_DIR):
        return out
    for name in sorted(os.listdir(SESSION_DIR)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(SESSION_DIR, name)
        try:
            with open(path) as f:
                pid = json.load(f).get("pid")
        except (OSError, ValueError, AttributeError):
            out.append(path)  # unreadable / not JSON / not a dict
            continue
        if not isinstance(pid, int) or pid <= 0 or not pid_alive(pid):
            out.append(path)
    return out


def orphaned_segments(min_age_s: float = 60.0,
                      shm_prefix: Optional[str] = None
                      ) -> List[Tuple[str, int]]:
    """(segment name, creator pid) for shm segments with a dead
    creator that are at least ``min_age_s`` old.

    Only names matching the exact ShmBtl pattern
    ``<prefix><digits>-...`` on REGULAR files are candidates —
    anything else under /dev/shm is skipped, never reaped. (The
    per-user session dir itself lands in /dev/shm when
    ``TMPDIR=/dev/shm``, and its ``ompitpu-sessions-<uid>`` name
    would otherwise read as 'unparseable debris'.)"""
    prefix = SHM_PREFIX if shm_prefix is None else shm_prefix
    out = []
    if not os.path.isdir(SHM_DIR):
        return out
    now = time.time()
    for name in sorted(os.listdir(SHM_DIR)):
        if not name.startswith(prefix):
            continue
        try:
            st = os.stat(os.path.join(SHM_DIR, name))
        except OSError:
            continue  # vanished mid-scan
        if not stat_mod.S_ISREG(st.st_mode):
            continue
        if now - st.st_mtime < min_age_s:
            continue
        rest = name[len(prefix):]
        pid_s = rest.split("-", 1)[0]
        if not pid_s.isdigit():
            continue  # not a ShmBtl segment: not ours to touch
        pid = int(pid_s)
        if not pid_alive(pid):
            out.append((name, pid))
    return out


def clean(dry_run: bool = False, verbose: bool = False,
          min_age_s: float = 60.0, shm_prefix: Optional[str] = None,
          out=sys.stdout) -> Tuple[int, int]:
    """Remove stale sessions + orphaned segments; returns counts of
    entries actually removed (dry-run: entries that would be tried)."""
    from multiprocessing import shared_memory

    n_sessions = 0
    for path in stale_sessions():
        if verbose or dry_run:
            print(f"{'would remove' if dry_run else 'removing'} stale "
                  f"session file {path}", file=out)
        if not dry_run:
            try:
                os.unlink(path)
            except OSError as e:
                print(f"tpu-clean: cannot remove {path}: {e}",
                      file=sys.stderr)
                continue
        n_sessions += 1
    n_segs = 0
    for name, pid in orphaned_segments(min_age_s, shm_prefix):
        if verbose or dry_run:
            print(f"{'would remove' if dry_run else 'removing'} "
                  f"orphaned shm segment {name} (pid {pid} dead)",
                  file=out)
        if not dry_run:
            try:
                seg = shared_memory.SharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                continue  # raced its own receiver/reaper: fine
            except OSError as e:
                print(f"tpu-clean: cannot remove segment {name}: {e}",
                      file=sys.stderr)
                continue
        n_segs += 1
    return n_sessions, n_segs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-clean",
        description="Remove stale session files and orphaned shm "
                    "segments of dead jobs (orte-clean analogue)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what would be removed, remove nothing")
    ap.add_argument("--min-age", type=float, default=60.0,
                    help="only reap shm segments older than this many "
                         "seconds (guards in-flight ownership "
                         "handoffs)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    n_sessions, n_segs = clean(dry_run=args.dry_run,
                               verbose=args.verbose,
                               min_age_s=args.min_age)
    verb = "would remove" if args.dry_run else "removed"
    print(f"tpu-clean: {verb} {n_sessions} stale session file(s), "
          f"{n_segs} orphaned shm segment(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
