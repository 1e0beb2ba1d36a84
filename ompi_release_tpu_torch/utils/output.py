"""Verbosity-stream logging + tagged help catalogs (the port's own copy
of ``ompi_release_tpu/utils/output.py``).

Re-imagination of ``opal/util/output.c`` (numbered verbosity streams per
subsystem, routable to stderr/file) and ``opal/util/show_help.c``
(tag-indexed user-facing message catalogs, de-duplicated). Stream
verbosity is controlled by the ``<name>_verbose`` MCA variable so every
subsystem gets a debug knob for free, exactly as in the reference.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Optional, TextIO

_lock = threading.RLock()
_streams: Dict[str, "Stream"] = {}
_help_catalogs: Dict[str, Dict[str, str]] = {}
_help_seen: set = set()
_sink: Optional[TextIO] = None  # default: stderr; tests may redirect


def set_sink(fh: Optional[TextIO]) -> None:
    global _sink
    with _lock:
        _sink = fh


def _out() -> TextIO:
    return _sink if _sink is not None else sys.stderr


class Stream:
    """One named, leveled output stream (``opal_output_open`` analogue)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._var_name = name.replace(".", "_").replace("/", "_") + "_verbose"

    @property
    def verbosity(self) -> int:
        # late import to avoid an import cycle with mca.var
        from ..mca import var as mca_var

        v = mca_var.get(self._var_name)
        if v is None:
            v = os.environ.get(mca_var.ENV_PREFIX + self._var_name)
        try:
            return int(v) if v is not None else 0
        except (TypeError, ValueError):
            # logging must never crash the caller on a garbage env value
            return 0

    def _emit(self, prefix: str, msg: str) -> None:
        pid = os.getpid()
        line = f"[{time.strftime('%H:%M:%S')}] [{pid}] {prefix}{self.name}: {msg}\n"
        with _lock:
            _out().write(line)
            _out().flush()

    def verbose(self, level: int, msg: str) -> None:
        if self.verbosity >= level:
            self._emit("", msg)

    def info(self, msg: str) -> None:
        self._emit("", msg)

    def warn(self, msg: str) -> None:
        self._emit("WARNING: ", msg)

    def error(self, msg: str) -> None:
        self._emit("ERROR: ", msg)


def stream(name: str) -> Stream:
    with _lock:
        st = _streams.get(name)
        if st is None:
            st = Stream(name)
            _streams[name] = st
        return st


def register_help(catalog: str, messages: Dict[str, str]) -> None:
    """Register a tag→template catalog (the ``help-*.txt`` analogue)."""
    with _lock:
        _help_catalogs.setdefault(catalog, {}).update(messages)


def show_help(catalog: str, tag: str, *, once: bool = True, **kwargs: Any) -> str:
    """Emit a formatted user-facing message; de-duplicated per tag.

    The reference aggregates identical help messages across ranks
    (``opal/util/show_help.c``); in-process we de-duplicate per
    (catalog, tag) unless ``once=False``.
    """
    with _lock:
        template = _help_catalogs.get(catalog, {}).get(tag)
        if template is None:
            text = f"[help {catalog}:{tag}] (no catalog entry) {kwargs}"
        else:
            try:
                text = template.format(**kwargs)
            except Exception:
                text = template + f" {kwargs}"
        key = (catalog, tag)
        if once and key in _help_seen:
            return text
        _help_seen.add(key)
        banner = "-" * 60
        _out().write(f"{banner}\n{text}\n{banner}\n")
        _out().flush()
        return text


def _reset_for_tests() -> None:
    with _lock:
        _help_seen.clear()
