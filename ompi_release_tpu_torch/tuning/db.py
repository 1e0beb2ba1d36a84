"""Versioned per-topology tuning database: measured decision tables a
fleet selects by fingerprint instead of by hand (counterpart of
``ompi_release_tpu/tuning/db.py``).

fingerprint
    :class:`Fingerprint` canonicalizes the four keys schedule selection
    depends on: host count, processes per host (0 = ragged), the link
    classes between them (``local`` single-process, ``shm`` one host,
    ``shm+dcn`` spanning), and the process count P. It round-trips
    through the ``# fingerprint:`` header stanza that
    :mod:`..coll.dynamic_rules` parses.

database layout
    A directory of ordinary rule files, ``<slug>-vN.conf``, each a
    valid dynamic-rules file whose header stanza carries its
    fingerprint and version. :meth:`TuningDb.register` validates
    through the real loader BEFORE publishing and never overwrites:
    re-tuning the same topology writes v2, v3, ...

selection
    :func:`select_rules_path`: exact fingerprint match at the highest
    version, else the nearest entry over the same link classes (same
    procs-per-host preferred, then closest P, then closest host count).
    ``dynamic_rules`` consults it when ``coll_tuning_db_dir`` is set and
    no explicit rules filename is. Precedence: forcing > rules
    (explicit file > DB entry) > fixed decision constants.

A single-process job (every port job so far) runs under :data:`LOCAL`
unless :func:`set_active` publishes another fingerprint.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, List, Mapping, Optional, Tuple

from ..mca import pvar
from ..mca import var as mca_var
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("tuning")

#: uncached database resolutions (misses of the per-(dir, fingerprint)
#: selection cache: a register moves the dir mtime -> one re-resolve)
_db_resolves = pvar.counter(
    "tuning_db_resolves",
    "tuning-database best-match resolutions (selection-cache misses)",
)


def register_vars() -> None:
    mca_var.register(
        "coll_tuning_db_dir", "str", "",
        "Directory of the versioned per-topology tuning database. When "
        "set and no explicit coll_tuned_dynamic_rules_filename is, "
        "dynamic rules select the best-matching entry for the job's "
        "topology fingerprint; empty disables",
    )


register_vars()  # idempotent; the cvar must exist before any lookup


# ---------------------------------------------------------------------------
# the topology fingerprint
# ---------------------------------------------------------------------------

_CANON_RE = re.compile(
    r"^hosts=(\d+);ppn=(\d+);links=([a-z0-9+]+);P=(\d+)$")


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """The four keys schedule selection depends on. ``procs_per_host``
    is 0 when hosts hold unequal process counts (a ragged layout never
    exact-matches a uniform one)."""

    hosts: int
    procs_per_host: int
    link_classes: Tuple[str, ...]
    P: int

    def canon(self) -> str:
        """The canonical one-line form the header stanza carries."""
        return (f"hosts={self.hosts};ppn={self.procs_per_host};"
                f"links={'+'.join(self.link_classes)};P={self.P}")

    def slug(self) -> str:
        """Filesystem-safe entry-name stem."""
        return (f"h{self.hosts}ppn{self.procs_per_host}p{self.P}-"
                + "-".join(self.link_classes))

    @classmethod
    def parse(cls, text: str) -> "Fingerprint":
        m = _CANON_RE.match(str(text).strip())
        if not m:
            raise ValueError(
                f"malformed topology fingerprint {text!r} (expected "
                "'hosts=H;ppn=N;links=a+b;P=P')")
        return cls(int(m.group(1)), int(m.group(2)),
                   tuple(m.group(3).split("+")), int(m.group(4)))


#: the single-process fallback fingerprint (in-process collectives never
#: cross a link; the DB still matches "local" entries exactly)
LOCAL = Fingerprint(hosts=1, procs_per_host=1,
                    link_classes=("local",), P=1)


def fingerprint_for(host_of: Mapping[int, str], P: int) -> Fingerprint:
    """Fingerprint of one spanning layout: the rank -> host map plus the
    process count. One host rides shm, several ride shm+dcn."""
    sizes: Dict[str, int] = {}
    for p in host_of:
        sizes[host_of[p]] = sizes.get(host_of[p], 0) + 1
    hosts = max(1, len(sizes))
    uniform = len(set(sizes.values())) == 1 if sizes else True
    ppn = next(iter(sizes.values())) if (sizes and uniform) else 0
    links = ("shm", "dcn") if hosts > 1 else ("shm",)
    return Fingerprint(hosts=hosts, procs_per_host=ppn,
                       link_classes=links, P=int(P))


_active_lock = threading.Lock()
_active: Optional[Fingerprint] = None


def set_active(fp: Fingerprint, force: bool = True) -> None:
    """Publish the job's topology fingerprint. With ``force=False`` the
    WIDEST layout seen wins (a sub-communicator must not steer the
    job-wide selection); ``force=True`` replaces unconditionally."""
    global _active
    with _active_lock:
        if force or _active is None or fp.P >= _active.P:
            _active = fp


def active() -> Fingerprint:
    with _active_lock:
        return _active if _active is not None else LOCAL


def _reset_for_tests() -> None:
    global _active
    with _active_lock:
        _active = None
    with _select_lock:
        _select_cache.clear()


# ---------------------------------------------------------------------------
# header stanza helpers (shared with dynamic_rules)
# ---------------------------------------------------------------------------

FP_LINE_RE = re.compile(r"^#\s*fingerprint:\s*(.+?)\s*$")
VERSION_LINE_RE = re.compile(r"^#\s*version:\s*(\d+)\s*$")


def stamp(text: str, fp: Fingerprint, version: Optional[int] = None,
          source: Optional[str] = None) -> str:
    """Prepend (or replace) the fingerprint header stanza on one rules
    file's text."""
    lines = [ln for ln in text.splitlines()
             if not (FP_LINE_RE.match(ln) or VERSION_LINE_RE.match(ln))]
    head = [f"# fingerprint: {fp.canon()}"]
    if version is not None:
        head.append(f"# version: {int(version)}")
    if source:
        head.append(f"# db-source: {source}")
    return "\n".join(head + lines) + "\n"


def read_header(path: str) -> Tuple[Optional[Fingerprint],
                                    Optional[int]]:
    """(fingerprint, version) from one rules file's comment header, or
    (None, None) for a file without the stanza. A malformed stanza
    raises: an entry whose key silently failed to parse would be
    unselectable with no symptom."""
    fp: Optional[Fingerprint] = None
    version: Optional[int] = None
    try:
        with open(path) as f:
            for line in f:
                m = FP_LINE_RE.match(line)
                if m:
                    try:
                        fp = Fingerprint.parse(m.group(1))
                    except ValueError as e:
                        raise MPIError(ErrorCode.ERR_ARG,
                                       f"{path}: {e}")
                m = VERSION_LINE_RE.match(line)
                if m:
                    version = int(m.group(1))
    except OSError as e:
        raise MPIError(ErrorCode.ERR_FILE,
                       f"cannot read tuning entry {path}: {e}")
    return fp, version


# ---------------------------------------------------------------------------
# the database
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Entry:
    fingerprint: Fingerprint
    version: int
    path: str


class TuningDb:
    """One directory of fingerprint-stamped, versioned rule files."""

    def __init__(self, root: str) -> None:
        self.root = str(root)

    def entries(self) -> List[Entry]:
        """Every selectable entry (files without a fingerprint stanza
        are skipped: nothing to match them by)."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        out: List[Entry] = []
        for name in names:
            if not name.endswith(".conf"):
                continue
            path = os.path.join(self.root, name)
            fp, version = read_header(path)
            if fp is None:
                continue
            out.append(Entry(fp, version or 1, path))
        return out

    def register(self, text: str, fp: Fingerprint,
                 source: str = "tune") -> str:
        """Publish one rules file under ``fp`` at the next version. The
        text is stamped, then validated through the REAL rule loader
        before the rename publishes it: the database never serves a
        file that fails at job start."""
        from ..coll import components  # noqa: F401  (rule namespaces)
        from ..coll import dynamic_rules

        os.makedirs(self.root, exist_ok=True)
        version = 1 + max(
            (e.version for e in self.entries() if e.fingerprint == fp),
            default=0)
        stamped = stamp(text, fp, version=version, source=source)
        path = os.path.join(self.root, f"{fp.slug()}-v{version}.conf")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(stamped)
        try:
            dynamic_rules.load_rules(tmp)  # loud on any typo
        except MPIError:
            os.unlink(tmp)
            raise
        os.replace(tmp, path)
        _log.verbose(1, f"tuning db: registered {fp.canon()} "
                        f"v{version} -> {path}")
        return path

    def best_match(self, fp: Fingerprint) -> Optional[str]:
        """The entry serving ``fp``: exact match at the highest version,
        else the nearest same-link-class entry (matching procs-per-host
        preferred, then closest P, then closest host count, then
        newest). None when no entry shares the link classes: a local
        table must never steer a spanning job."""
        cands = [e for e in self.entries()
                 if e.fingerprint.link_classes == fp.link_classes]
        if not cands:
            return None
        exact = [e for e in cands if e.fingerprint == fp]
        if exact:
            return max(exact, key=lambda e: e.version).path
        cands.sort(key=lambda e: (
            e.fingerprint.procs_per_host != fp.procs_per_host,
            abs(e.fingerprint.P - fp.P),
            abs(e.fingerprint.hosts - fp.hosts),
            -e.version, e.path))
        return cands[0].path


# ---------------------------------------------------------------------------
# selection cache (the dynamic_rules auto-select path)
# ---------------------------------------------------------------------------

_select_lock = threading.Lock()
#: (root, fingerprint canon) -> (dir mtime_ns, resolved path|None)
_select_cache: Dict[Tuple[str, str],
                    Tuple[int, Optional[str]]] = {}


def select_rules_path(root: Optional[str] = None,
                      fp: Optional[Fingerprint] = None) -> Optional[str]:
    """The DB entry the current job should load, or None (no DB dir /
    no matching entry). Cached per (dir, fingerprint) and invalidated
    by the directory's mtime: ``register`` always creates a NEW file,
    so a re-tune moves the mtime and the next lookup re-resolves."""
    root = root if root is not None \
        else str(mca_var.get("coll_tuning_db_dir", "") or "")
    if not root:
        return None
    fp = fp or active()
    try:
        dir_mtime = os.stat(root).st_mtime_ns
    except OSError:
        return None  # no DB yet: fall through to fixed constants
    key = (root, fp.canon())
    with _select_lock:
        cached = _select_cache.get(key)
        if cached is not None and cached[0] == dir_mtime:
            return cached[1]
    path = TuningDb(root).best_match(fp)
    _db_resolves.add()
    with _select_lock:
        _select_cache[key] = (dir_mtime, path)
    if path:
        _log.verbose(2, f"tuning db: {fp.canon()} -> {path}")
    return path
