"""MPI_Info — the ``ompi/info`` analogue (the port's own copy of
``ompi_release_tpu/comm/info.py``).

The reference implements info objects as ordered key/value lists with
bounded key/value lengths and a set of reserved keys surfaced through
``MPI_INFO_ENV`` (``ompi/info/info.c``). Same surface here: create /
set / get / delete / dup / nkeys / nthkey, insertion-ordered (MPI
requires MPI_Info_get_nthkey to enumerate in a consistent order),
plus ``INFO_ENV`` pre-populated from the runtime environment the way
``MPI_INFO_ENV`` carries command/argv/maxprocs/soft etc.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator, Optional

from ..utils.errors import ErrorCode, MPIError

MAX_KEY_LEN = 255    # MPI_MAX_INFO_KEY
MAX_VALUE_LEN = 1024  # MPI_MAX_INFO_VAL


class Info:
    """Insertion-ordered string->string map with MPI's validation."""

    def __init__(self, initial: Optional[Dict[str, str]] = None) -> None:
        self._kv: Dict[str, str] = {}
        if initial:
            for k, v in initial.items():
                self.set(k, v)

    @staticmethod
    def _check_key(key: str) -> None:
        if not isinstance(key, str) or not key:
            raise MPIError(ErrorCode.ERR_ARG, "info key must be non-empty")
        if len(key) > MAX_KEY_LEN:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"info key exceeds MPI_MAX_INFO_KEY ({MAX_KEY_LEN})",
            )

    def set(self, key: str, value: str) -> None:
        """MPI_Info_set (overwrites like the reference)."""
        self._check_key(key)
        value = str(value)
        if len(value) > MAX_VALUE_LEN:
            raise MPIError(
                ErrorCode.ERR_ARG,
                f"info value exceeds MPI_MAX_INFO_VAL ({MAX_VALUE_LEN})",
            )
        self._kv[key] = value  # dict preserves insertion order

    def get(self, key: str) -> Optional[str]:
        """MPI_Info_get: value or None when unset (flag=false)."""
        self._check_key(key)
        return self._kv.get(key)

    def delete(self, key: str) -> None:
        """MPI_Info_delete: ERR on missing key (MPI_ERR_INFO_NOKEY)."""
        self._check_key(key)
        if key not in self._kv:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"info key '{key}' not set (MPI_ERR_INFO_NOKEY)")
        del self._kv[key]

    def dup(self) -> "Info":
        """MPI_Info_dup: independent deep copy."""
        return Info(dict(self._kv))

    @property
    def nkeys(self) -> int:
        return len(self._kv)

    def nthkey(self, n: int) -> str:
        """MPI_Info_get_nthkey: insertion order, range-checked."""
        if not 0 <= n < len(self._kv):
            raise MPIError(ErrorCode.ERR_ARG,
                           f"info has {len(self._kv)} keys, asked for {n}")
        return list(self._kv)[n]

    def keys(self) -> Iterator[str]:
        return iter(self._kv)

    def items(self):
        return self._kv.items()

    def as_dict(self) -> Dict[str, str]:
        return dict(self._kv)

    def __contains__(self, key: str) -> bool:
        return key in self._kv

    def __len__(self) -> int:
        return len(self._kv)

    def __repr__(self) -> str:
        return f"Info({self._kv})"


def _build_info_env() -> Info:
    """MPI_INFO_ENV: the reserved startup keys the reference fills
    from the launch environment (``ompi/runtime/ompi_mpi_init.c``
    MPI_INFO_ENV setup)."""
    info = Info()
    info.set("command", sys.argv[0] if sys.argv else "")
    info.set("argv", " ".join(sys.argv[1:])[:MAX_VALUE_LEN])
    if os.environ.get("OMPITPU_NUM_NODES"):
        info.set("maxprocs", os.environ["OMPITPU_NUM_NODES"])
    info.set("soft", "")
    info.set("host", os.environ.get("OMPITPU_HOST", ""))
    info.set("arch", sys.platform)
    info.set("wdir", os.getcwd()[:MAX_VALUE_LEN])
    info.set("thread_level", "MPI_THREAD_MULTIPLE")
    return info


INFO_ENV = _build_info_env()
INFO_NULL = None  # MPI_INFO_NULL: the absence of an info object
