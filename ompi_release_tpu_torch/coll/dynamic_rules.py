"""tuned dynamic rule files — operator-supplied decision tables
(counterpart of ``ompi_release_tpu/coll/dynamic_rules.py``;
``coll_tuned_dynamic_file.c`` analogue).

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
reduce, gather: bytes per rank; allgather: total bytes; alltoall and
scatter: bytes per destination block). Selected with
``coll_tuned_use_dynamic_rules`` + ``coll_tuned_dynamic_rules_filename``;
unknown collectives or algorithms fail at load time with the file and
line number.

A file may carry the tuning database's topology-fingerprint stanza::

    # fingerprint: hosts=1;ppn=1;links=local;P=1
    # version: 2

It is parsed, not skipped (a malformed stanza fails at load with its
line number) and exposed through :func:`load_rules_doc` /
:func:`rules_source`. When ``coll_tuning_db_dir`` is set and NO explicit
rules filename is, the database entry best matching the job's
fingerprint (:mod:`..tuning.db`) is the rule file; the explicit file
outranks the database. Files without the stanza keep the legacy
semantics.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from ..mca import var as mca_var
from ..tuning import db as _tuning_db
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("coll")

#: collective name -> algorithms a rule may name (filled by
#: components.py at import; kept here to avoid a cycle)
RULE_COLLECTIVES: Dict[str, Tuple[str, ...]] = {
    # parallel/tree's planned whole-tree passes register here directly:
    # min_comm_size is the participant count, min_msg_bytes the TOTAL
    # tree bytes, and the 5th (segsize) column the fused bucket capacity
    # in bytes; "per_leaf" pins bucketing off. Consumed by
    # parallel.tree.resolve_bucket_bytes.
    "tree_buckets": ("auto", "fused", "per_leaf"),
}

Rules = Dict[str, List[Tuple[int, int, str, Optional[int]]]]

# (path, mtime_ns, size) -> (parsed rules, header meta); a rewritten
# file is re-parsed, an unchanged one costs a stat per lookup
_cache: Dict[Tuple[str, int, int], Tuple[Rules, Dict]] = {}
_cache_lock = threading.Lock()


def load_rules_doc(path: str) -> Tuple[Rules, Dict]:
    """Parse a rule file into ``(rules, meta)``: rules is {collective:
    [(min_n, min_bytes, alg, segsize)]} preserving file order; meta is
    the header stanza, ``{"fingerprint": canonical str | None,
    "version": int | None}``."""
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise MPIError(ErrorCode.ERR_FILE,
                       f"cannot read dynamic rules file {path}: {e}")
    rules: Rules = {}
    meta: Dict = {"fingerprint": None, "version": None}
    for lineno, line in enumerate(lines, 1):
        m = _tuning_db.FP_LINE_RE.match(line)
        if m:
            try:
                fp = _tuning_db.Fingerprint.parse(m.group(1))
            except ValueError as e:
                raise MPIError(ErrorCode.ERR_ARG, f"{path}:{lineno}: {e}")
            meta["fingerprint"] = fp.canon()
            continue
        m = _tuning_db.VERSION_LINE_RE.match(line)
        if m:
            meta["version"] = int(m.group(1))
            continue
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
    return rules, meta


def load_rules(path: str) -> Rules:
    """The rule table of :func:`load_rules_doc` alone."""
    return load_rules_doc(path)[0]


def _db_selected_path() -> Optional[str]:
    """The tuning database's entry for the active topology fingerprint,
    or None (no ``coll_tuning_db_dir`` / no matching entry: the fixed
    constants apply, as if no file were named)."""
    if not mca_var.get("coll_tuning_db_dir", ""):
        return None
    return _tuning_db.select_rules_path()


def _active_doc() -> Tuple[Optional[Rules], Optional[Dict],
                           Optional[str], str]:
    """(rules, meta, path, mode) of the configured rule table; (None,
    None, None, "off") when dynamic rules are off or nothing is
    configured. The explicit filename outranks the database."""
    if not mca_var.get("coll_tuned_use_dynamic_rules", False):
        return None, None, None, "off"
    path = mca_var.get("coll_tuned_dynamic_rules_filename", "")
    mode = "file"
    if not path:
        path = _db_selected_path()
        mode = "db"
        if not path:
            return None, None, None, "off"
    try:
        st = os.stat(path)
    except OSError as e:
        # the file vanished mid-run: keep serving the last parsed copy;
        # only a file that never parsed is fatal
        with _cache_lock:
            doc = next((d for (p, _, _), d in _cache.items() if p == path),
                       None)
        if doc is None:
            raise MPIError(ErrorCode.ERR_FILE,
                           f"dynamic rules file {path} unreadable: {e}")
        return doc[0], doc[1], path, mode
    key = (path, st.st_mtime_ns, st.st_size)
    with _cache_lock:
        doc = _cache.get(key)
    if doc is None:
        doc = load_rules_doc(path)  # parse before dropping the old copy
        with _cache_lock:
            _cache.clear()
            _cache[key] = doc
    return doc[0], doc[1], path, mode


def _active_rules() -> Optional[Rules]:
    """The configured rule table, or None when dynamic rules are off."""
    return _active_doc()[0]


def rules_source() -> Dict[str, Optional[str]]:
    """Where the live rule table comes from: ``{"mode": "off" | "file"
    | "db", "path", "fingerprint"}`` (the loaded file's stamped
    fingerprint, None for a file without the stanza)."""
    _rules, meta, path, mode = _active_doc()
    return {"mode": mode, "path": path,
            "fingerprint": (meta or {}).get("fingerprint")}


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
