"""MCA-style typed configuration variable system (the port's own copy
of ``ompi_release_tpu/mca/var.py``: same ``OMPITPU_MCA_<name>``
environment prefix and param-file format, so one configuration drives
both packages, but a separate registry).

Re-design of the reference's MCA variable system
(``opal/mca/base/mca_base_var.c``, 2064 LoC): every framework/component
registers typed, documented variables into one global registry; values are
resolved with the same precedence order the reference uses
(``mca_base_var.c`` source enum): explicit set/CLI override > environment
variable > parameter file > registered default.

Reference parity notes:
  - variable naming follows ``<framework>_<component>_<name>`` (e.g.
    ``coll_tuned_allreduce_algorithm``), like ``mca_base_var_register``.
  - env lookup uses the ``OMPITPU_MCA_<name>`` prefix (reference uses
    ``OMPI_MCA_<name>``, ``opal/mca/base/mca_base_var.c``).
  - param files are ``key = value`` lines (``mca_base_parse_paramfile.c``).
  - enum-valued variables mirror e.g. the allreduce algorithm enum
    (``ompi/mca/coll/tuned/coll_tuned_allreduce.c:46-54``).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence

ENV_PREFIX = "OMPITPU_MCA_"


class VarSource(enum.IntEnum):
    """Where a variable's current value came from (priority order)."""

    DEFAULT = 0
    FILE = 1
    ENV = 2
    OVERRIDE = 3  # CLI --mca or programmatic set_value


class VarScope(enum.IntEnum):
    """Mirror of MCA_BASE_VAR_SCOPE_*: may the value change after init?

    READONLY/CONSTANT forbid *runtime* writes (set_value/apply_cli after
    the variable is registered). Launch-time sources — env, param files,
    and CLI overrides recorded before registration — still apply, same
    as the reference, where READONLY MCA vars are set via OMPI_MCA_* at
    launch but rejected by MPI_T_cvar_write afterwards.
    """

    CONSTANT = 0   # never changes
    READONLY = 1   # fixed once registered/resolved
    LOCAL = 2      # may differ per process
    ALL = 3        # settable any time


class VarLevel(enum.IntEnum):
    """Mirror of MCA_BASE_VAR_INFO_LVL_* (1..9): user → developer detail."""

    USER_BASIC = 1
    USER_DETAIL = 2
    USER_ALL = 3
    TUNER_BASIC = 4
    TUNER_DETAIL = 5
    TUNER_ALL = 6
    DEV_BASIC = 7
    DEV_DETAIL = 8
    DEV_ALL = 9


_SIZE_SUFFIX = {
    "": 1,
    "k": 1 << 10,
    "kb": 1 << 10,
    "m": 1 << 20,
    "mb": 1 << 20,
    "g": 1 << 30,
    "gb": 1 << 30,
}

_TRUE = {"1", "true", "yes", "on", "enabled"}
_FALSE = {"0", "false", "no", "off", "disabled"}


def parse_size(text: str) -> int:
    """Parse ``64K`` / ``1M`` / ``4096`` into bytes."""
    m = re.fullmatch(r"\s*(\d+)\s*([kKmMgG][bB]?)?\s*", str(text))
    if not m:
        raise ValueError(f"cannot parse size value {text!r}")
    return int(m.group(1)) * _SIZE_SUFFIX[(m.group(2) or "").lower()]


def _coerce(vtype: str, value: Any, choices: Optional[Sequence[str]]) -> Any:
    if value is None:
        return None
    if vtype == "int":
        return int(value)
    if vtype == "float":
        return float(value)
    if vtype == "size":
        if isinstance(value, (int, float)):
            return int(value)
        return parse_size(value)
    if vtype == "bool":
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"cannot parse bool value {value!r}")
    if vtype == "str":
        return str(value)
    if vtype == "enum":
        s = str(value)
        assert choices is not None
        if s not in choices:
            raise ValueError(f"value {s!r} not in enum choices {list(choices)}")
        return s
    if vtype == "list":
        if isinstance(value, (list, tuple)):
            return [str(v) for v in value]
        s = str(value).strip()
        return [p for p in (x.strip() for x in s.split(",")) if p]
    raise ValueError(f"unknown variable type {vtype!r}")


@dataclasses.dataclass
class Var:
    """One registered configuration variable."""

    name: str
    vtype: str  # int | float | bool | str | enum | size | list
    default: Any
    help: str = ""
    scope: VarScope = VarScope.ALL
    level: VarLevel = VarLevel.USER_BASIC
    choices: Optional[Sequence[str]] = None
    # resolved state
    value: Any = None
    source: VarSource = VarSource.DEFAULT
    deprecated: bool = False
    synonyms: Sequence[str] = ()

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": self.vtype,
            "value": self.value,
            "default": self.default,
            "source": self.source.name,
            "scope": self.scope.name,
            "level": int(self.level),
            "help": self.help,
            "choices": list(self.choices) if self.choices else None,
        }


class VarRegistry:
    """Global registry of typed variables (the ``mca_base_var`` table)."""

    def __init__(self) -> None:
        self._vars: Dict[str, Var] = {}
        self._lock = threading.RLock()
        self._file_values: Dict[str, str] = {}
        self._overrides: Dict[str, str] = {}
        self._files_loaded: List[str] = []
        #: monotone write generation: bumped on every successful value
        #: change (set_value/unset/apply_cli/param file/env refresh and
        #: first-time registrations). Hot paths cache resolved values
        #: stamped with this integer — one plain attribute read and an
        #: int compare replaces a per-message lock + dict lookup, and a
        #: stale stamp says exactly when to re-resolve (the "cvar
        #: writes take effect at the next plan" contract).
        self.generation: int = 0

    # -- registration -----------------------------------------------------
    def register(
        self,
        name: str,
        vtype: str,
        default: Any,
        help: str = "",
        *,
        scope: VarScope = VarScope.ALL,
        level: VarLevel = VarLevel.USER_BASIC,
        choices: Optional[Sequence[str]] = None,
        synonyms: Sequence[str] = (),
    ) -> Var:
        """Register a variable and resolve its value immediately.

        Re-registering the same name with the same type is idempotent and
        returns the existing variable (components may be re-opened).
        """
        with self._lock:
            if name in self._vars:
                existing = self._vars[name]
                if existing.vtype != vtype:
                    raise ValueError(
                        f"variable {name!r} re-registered with type "
                        f"{vtype!r} != {existing.vtype!r}"
                    )
                return existing
            if vtype == "enum" and not choices:
                raise ValueError(f"enum variable {name!r} needs choices")
            var = Var(
                name=name,
                vtype=vtype,
                default=_coerce(vtype, default, choices),
                help=help,
                scope=scope,
                level=level,
                choices=tuple(choices) if choices else None,
                synonyms=tuple(synonyms),
            )
            # resolve before publishing: an invalid env/file value must not
            # leave a half-initialized var in the registry
            self._resolve(var)
            self._vars[name] = var
            self.generation += 1  # a NEW var changes get() results
            return var

    # -- value resolution (precedence) ------------------------------------
    def _raw_lookup(self, var: Var) -> tuple:
        names = (var.name, *var.synonyms)
        for n in names:
            if n in self._overrides:
                return self._overrides[n], VarSource.OVERRIDE
        for n in names:
            env = os.environ.get(ENV_PREFIX + n)
            if env is not None:
                return env, VarSource.ENV
        for n in names:
            if n in self._file_values:
                return self._file_values[n], VarSource.FILE
        return var.default, VarSource.DEFAULT

    def _resolve(self, var: Var) -> None:
        raw, source = self._raw_lookup(var)
        try:
            var.value = _coerce(var.vtype, raw, var.choices)
        except ValueError as exc:
            raise ValueError(
                f"invalid value {raw!r} for MCA variable {var.name!r} "
                f"(type {var.vtype}, from {source.name}): {exc}"
            ) from None
        var.source = source

    def _resolve_all(self) -> None:
        for var in self._vars.values():
            self._resolve(var)

    # -- accessors ---------------------------------------------------------
    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            var = self._vars.get(name)
            if var is None:
                return default
            return var.value

    def lookup(self, name: str) -> Optional[Var]:
        with self._lock:
            return self._vars.get(name)

    def set_value(self, name: str, value: Any) -> None:
        """Programmatic/CLI override (highest precedence)."""
        with self._lock:
            var = self._vars.get(name)
            if var is not None and var.scope in (
                VarScope.CONSTANT, VarScope.READONLY
            ):
                raise PermissionError(
                    f"variable {name!r} has scope {var.scope.name}"
                )
            had_prev = name in self._overrides
            prev = self._overrides.get(name)
            self._overrides[name] = value
            self.generation += 1
            if var is not None:
                try:
                    self._resolve(var)
                except (ValueError, TypeError):
                    # a REJECTED set must not poison the registry: the
                    # stored override would make every later get() of
                    # this variable raise (observed as cross-test
                    # contamination) — roll back to the prior state.
                    # TypeError included: int([1, 2]) raises it, not
                    # ValueError, and would slip the same poison past
                    # a ValueError-only net
                    if had_prev:
                        self._overrides[name] = prev
                    else:
                        del self._overrides[name]
                    self._resolve(var)
                    raise

    def unset(self, name: str) -> None:
        with self._lock:
            self._overrides.pop(name, None)
            self.generation += 1
            var = self._vars.get(name)
            if var is not None:
                self._resolve(var)

    # -- param files / CLI -------------------------------------------------
    def load_param_file(self, path: str) -> int:
        """Load ``key = value`` lines; later files win over earlier ones."""
        parsed: Dict[str, str] = {}
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                parsed[key.strip()] = val.strip()
        with self._lock:
            self._file_values.update(parsed)
            self._files_loaded.append(path)
            self.generation += 1
            self._resolve_all()
        return len(parsed)

    def apply_cli(self, pairs: Iterable[tuple]) -> None:
        """Apply ``--mca key value`` pairs from a command line.

        READONLY/CONSTANT variables are skipped with a warning instead
        of raising — a bad CLI flag must not abort the whole launch.
        """
        from ..utils import output

        with self._lock:
            for key, val in pairs:
                var = self._vars.get(key)
                if var is not None and var.scope in (
                    VarScope.CONSTANT, VarScope.READONLY
                ):
                    output.stream("mca.var").warn(
                        f"ignoring --mca {key}: scope {var.scope.name}"
                    )
                    continue
                self._overrides[key] = val
            self.generation += 1
            self._resolve_all()

    def refresh_from_env(self) -> None:
        """Re-read environment (tests mutate os.environ)."""
        with self._lock:
            self.generation += 1
            self._resolve_all()

    def describe_all(self, max_level: VarLevel = VarLevel.DEV_ALL) -> List[Dict]:
        with self._lock:
            return [
                v.describe()
                for v in sorted(self._vars.values(), key=lambda v: v.name)
                if int(v.level) <= int(max_level)
            ]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._vars)

    # -- test support ------------------------------------------------------
    def _reset_for_tests(self) -> None:
        with self._lock:
            self._vars.clear()
            self._file_values.clear()
            self._overrides.clear()
            self._files_loaded.clear()
            self.generation += 1


#: process-global registry — the single config mechanism (SURVEY §5).
VARS = VarRegistry()


def register(name: str, vtype: str, default: Any, help: str = "", **kw) -> Var:
    return VARS.register(name, vtype, default, help, **kw)


def get(name: str, default: Any = None) -> Any:
    return VARS.get(name, default)


def set_value(name: str, value: Any) -> None:
    VARS.set_value(name, value)
