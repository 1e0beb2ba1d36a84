"""tuned dynamic rule files — operator-supplied decision tables
(counterpart of ``ompi_release_tpu/coll/dynamic_rules.py``, file rules
only; ``coll_tuned_dynamic_file.c`` analogue).

Same line format as the reference::

    # collective  min_comm_size  min_msg_bytes  algorithm  [segsize]
    allreduce     0              0              recursive_doubling
    allreduce     0              1048576        ring       262144

The LAST line whose ``min_comm_size <= comm.size`` and
``min_msg_bytes <= message bytes`` wins; ``auto`` falls through to the
fixed decision constants. The optional ``segsize`` column is the
pipeline segment size in bytes (``auto`` or omitted = the
``coll_pipeline_segsize`` cvar, ``0`` = no pipelining). Each collective
measures ``min_msg_bytes`` in its own decision unit (allreduce, bcast,
reduce: bytes per rank; allgather: total bytes; alltoall: bytes per
destination block). Selected with ``coll_tuned_use_dynamic_rules`` +
``coll_tuned_dynamic_rules_filename``; unknown collectives or algorithms
fail at load time with the file and line number.

Not ported yet: the tuning database (``coll_tuning_db_dir``) and the
topology-fingerprint header stanza it keys on. Reaching either raises
``ERR_NOT_AVAILABLE`` rather than silently ignoring the configuration.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, List, Optional, Tuple

from ..mca import var as mca_var
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("coll")

#: collective name -> algorithms a rule may name (filled by
#: components.py at import; kept here to avoid a cycle)
RULE_COLLECTIVES: Dict[str, Tuple[str, ...]] = {}

#: the tuning database's header stanza (``# fingerprint: ...`` /
#: ``# version: N``), recognised only to refuse it
_DB_STANZA_RE = re.compile(r"^\s*#\s*(fingerprint|version)\s*:", re.I)

Rules = Dict[str, List[Tuple[int, int, str, Optional[int]]]]

# (path, mtime_ns, size) -> parsed rules; a rewritten file is re-parsed
_cache: Dict[Tuple[str, int, int], Rules] = {}
_cache_lock = threading.Lock()


def _not_ported(what: str) -> MPIError:
    return MPIError(ErrorCode.ERR_NOT_AVAILABLE,
                    f"{what}: the tuning database is not ported to "
                    "ompi_release_tpu_torch yet (use a plain rule file)")


def load_rules(path: str) -> Rules:
    """Parse a rule file into {collective: [(min_n, min_bytes, alg,
    segsize)]} preserving file order."""
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise MPIError(ErrorCode.ERR_FILE,
                       f"cannot read dynamic rules file {path}: {e}")
    rules: Rules = {}
    for lineno, line in enumerate(lines, 1):
        if _DB_STANZA_RE.match(line):
            raise _not_ported(f"{path}:{lineno}: tuning-database stanza")
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) not in (4, 5):
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"{path}:{lineno}: expected 'collective min_comm_size "
                f"min_msg_bytes algorithm [segsize]', got '{line}'",
            )
        coll, n_s, bytes_s, alg = parts[:4]
        if coll not in RULE_COLLECTIVES:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"{path}:{lineno}: unknown collective '{coll}' "
                f"(rule-capable: {', '.join(sorted(RULE_COLLECTIVES))})",
            )
        try:
            min_n, min_bytes = int(n_s), int(bytes_s)
        except ValueError:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"{path}:{lineno}: sizes must be integers in "
                           f"'{line}'")
        if min_n < 0 or min_bytes < 0:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"{path}:{lineno}: sizes must be >= 0")
        if alg not in RULE_COLLECTIVES[coll]:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"{path}:{lineno}: unknown {coll} algorithm '{alg}' "
                f"(choices: {', '.join(RULE_COLLECTIVES[coll])})",
            )
        segsize: Optional[int] = None
        if len(parts) == 5 and parts[4] != "auto":
            try:
                segsize = mca_var.parse_size(parts[4])
            except ValueError:
                raise MPIError(
                    ErrorCode.ERR_ARG,
                    f"{path}:{lineno}: segsize must be bytes (suffixes "
                    f"K/M/G ok) or 'auto', got '{parts[4]}'",
                )
        rules.setdefault(coll, []).append((min_n, min_bytes, alg, segsize))
    return rules


def _active_rules() -> Optional[Rules]:
    """The configured rule table, or None when dynamic rules are off."""
    if not mca_var.get("coll_tuned_use_dynamic_rules", False):
        return None
    path = mca_var.get("coll_tuned_dynamic_rules_filename", "")
    if not path:
        if mca_var.get("coll_tuning_db_dir", ""):
            raise _not_ported("coll_tuning_db_dir is set")
        return None
    try:
        st = os.stat(path)
    except OSError as e:
        # the file vanished mid-run: keep serving the last parsed copy;
        # only a file that never parsed is fatal
        with _cache_lock:
            rules = next((r for (p, _, _), r in _cache.items() if p == path),
                         None)
        if rules is None:
            raise MPIError(ErrorCode.ERR_FILE,
                           f"dynamic rules file {path} unreadable: {e}")
        return rules
    key = (path, st.st_mtime_ns, st.st_size)
    with _cache_lock:
        rules = _cache.get(key)
    if rules is None:
        rules = load_rules(path)  # parse before dropping the old copy
        with _cache_lock:
            _cache.clear()
            _cache[key] = rules
    return rules


def _last_match(coll: str, comm_size: int, msg_bytes: int, col: int):
    rules = _active_rules()
    if rules is None:
        return None
    picked = None
    for rule in rules.get(coll, ()):
        if comm_size >= rule[0] and msg_bytes >= rule[1]:
            picked = rule[col]
    return picked


def lookup(coll: str, comm_size: int, msg_bytes: int) -> Optional[str]:
    """The algorithm the rule file picks for this call, or None (no
    file / no matching rule / rule says auto)."""
    picked = _last_match(coll, comm_size, msg_bytes, 2)
    if picked == "auto":
        return None
    if picked is not None:
        _log.verbose(3, f"dynamic rule: {coll} n={comm_size} "
                        f"bytes={msg_bytes} -> {picked}")
    return picked


def lookup_segsize(coll: str, comm_size: int,
                   msg_bytes: int) -> Optional[int]:
    """The pipeline segment size the rule file picks for this call, or
    None (the caller falls back to ``coll_pipeline_segsize``)."""
    return _last_match(coll, comm_size, msg_bytes, 3)
