"""MPI_T tool interface — handle-based introspection of control and
performance variables (the port's own copy of
``ompi_release_tpu/mca/mpit.py``, over the port's registries).

The reference's ``ompi/mpi/tool`` exposes ``mca_base_var``/``pvar``
through MPI_T_cvar_* / MPI_T_pvar_* handles and sessions; tools bind a
handle to a variable, then read/write/reset through it. Same contract
over this framework's registries: indices are stable within a session,
cvar writes go through the registry's override layer (source=TOOL
wins like an API set), pvar sessions snapshot at start so reads can be
session-relative (the MPI_T pvar session semantic).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..utils.errors import ErrorCode, MPIError
from . import pvar as pvar_mod
from . import var as var_mod


class CvarHandle:
    def __init__(self, var) -> None:
        self._var = var

    @property
    def name(self) -> str:
        return self._var.name

    def read(self) -> Any:
        return var_mod.VARS.get(self._var.name)

    def write(self, value: Any) -> None:
        var_mod.VARS.set_value(self._var.name, value)

    def info(self) -> Dict[str, Any]:
        return self._var.describe()


def _session_delta(cur: Any, base: Any) -> Any:
    """Session-relative value since the handle's start snapshot.

    Scalars subtract; structured reads (HISTOGRAM/AGGREGATE) subtract
    elementwise — counts, sums, and per-bucket counts are cumulative so
    deltas are meaningful, while extrema ("min"/"max") are not
    invertible over a window and pass through as current values.
    """
    if isinstance(cur, dict):
        bd = base if isinstance(base, dict) else {}
        return {
            k: (v if k in ("min", "max") else _session_delta(v, bd.get(k, 0)))
            for k, v in cur.items()
        }
    if isinstance(cur, (int, float)) and isinstance(base, (int, float)):
        return float(cur) - float(base)
    return cur


class PvarHandle:
    def __init__(self, session: "PvarSession", pv) -> None:
        self._session = session
        self._pv = pv
        self._base: Any = 0.0
        self._started = False

    @property
    def name(self) -> str:
        return self._pv.name

    def start(self) -> None:
        self._base = self._pv.read()
        self._started = True

    def stop(self) -> None:
        self._started = False

    def read(self) -> Any:
        """Session-relative when started (delta since start); scalar
        pvars read as float, HISTOGRAM/AGGREGATE as their dict form."""
        v = self._pv.read()
        if self._started:
            return _session_delta(v, self._base)
        return float(v) if isinstance(v, (int, float)) else v

    def reset(self) -> None:
        self._base = self._pv.read()


class PvarSession:
    """MPI_T_pvar_session: scopes handle lifetimes."""

    def __init__(self) -> None:
        self._handles: List[PvarHandle] = []
        self._open = True

    def handle(self, name: str) -> PvarHandle:
        if not self._open:
            raise MPIError(ErrorCode.ERR_ARG, "pvar session closed")
        pv = pvar_mod.PVARS.lookup(name)
        if pv is None:
            raise MPIError(ErrorCode.ERR_ARG, f"unknown pvar {name!r}")
        h = PvarHandle(self, pv)
        self._handles.append(h)
        return h

    def free(self) -> None:
        self._handles.clear()
        self._open = False


class Mpit:
    """MPI_T_init_thread analogue: the tool-facing session object."""

    def __init__(self) -> None:
        self._cvar_names = var_mod.VARS.names()

    # -- control variables -------------------------------------------------
    def cvar_get_num(self) -> int:
        self._cvar_names = var_mod.VARS.names()
        return len(self._cvar_names)

    def cvar_get_info(self, index: int) -> Dict[str, Any]:
        name = self._cvar_names[index]
        return var_mod.VARS.lookup(name).describe()

    def cvar_handle(self, name_or_index) -> CvarHandle:
        if isinstance(name_or_index, int):
            name_or_index = self._cvar_names[name_or_index]
        v = var_mod.VARS.lookup(name_or_index)
        if v is None:
            raise MPIError(ErrorCode.ERR_ARG,
                           f"unknown cvar {name_or_index!r}")
        return CvarHandle(v)

    # -- performance variables ---------------------------------------------
    def pvar_get_num(self) -> int:
        return len(pvar_mod.PVARS.read_all())

    def pvar_names(self) -> List[str]:
        return sorted(pvar_mod.PVARS.read_all())

    def pvar_session(self) -> PvarSession:
        return PvarSession()
