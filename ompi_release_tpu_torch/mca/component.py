"""Framework / component / module lifecycle — the MCA analogue (the
port's own copy of ``ompi_release_tpu/mca/component.py``, with its own
framework table).

The reference's single most important architectural idea (SURVEY §1):
every subsystem is a *framework* (fixed interface) with N *components*
(plugins) that produce *modules* (instances), selected at runtime by
integer priority and user include/exclude lists. Lifecycle implemented
once here, mirroring ``opal/mca/base/mca_base_framework.c``,
``mca_base_components_open.c`` and ``mca_base_components_select.c``.

Selection syntax follows the reference: the MCA variable named after the
framework holds a comma list of components to include, or ``^a,b`` to
exclude (``mca_base_components_filter``). Priority query mirrors
``mca_base_select.c``: each opened component is asked for (priority,
module); highest priority wins; ``select_all`` returns every available
module sorted by priority (the per-communicator coll selection pattern,
``ompi/mca/coll/base/coll_base_comm_select.c:66-88``).
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Dict, List, Optional, Tuple

from . import var as mca_var
from ..utils import output


class ComponentState(enum.Enum):
    REGISTERED = "registered"
    OPENED = "opened"
    CLOSED = "closed"


class Component:
    """Base class for all components (plugins).

    Subclasses set ``NAME`` and ``PRIORITY`` and override ``query``;
    ``register_vars`` is called once at framework open so the component
    can register its MCA variables.
    """

    NAME: str = "base"
    PRIORITY: int = 0
    VERSION: Tuple[int, int, int] = (1, 0, 0)

    def __init__(self) -> None:
        self.framework: Optional["Framework"] = None
        self.state = ComponentState.REGISTERED

    # lifecycle ----------------------------------------------------------
    def register_vars(self) -> None:
        """Register this component's config variables (override)."""

    def open(self) -> bool:
        """Return False if the component cannot run in this environment."""
        return True

    def close(self) -> None:
        pass

    def query(self, ctx: Any = None) -> Optional[Tuple[int, Any]]:
        """Return (priority, module) if usable for ``ctx``, else None.

        Default: usable everywhere at the component's static priority,
        module is the component itself.
        """
        return (self.priority, self)

    # helpers ------------------------------------------------------------
    @property
    def priority(self) -> int:
        """Effective priority — overridable via ``<fw>_<name>_priority``."""
        if self.framework is not None:
            return mca_var.get(self._prefix() + "_priority", self.PRIORITY)
        return self.PRIORITY

    def _prefix(self) -> str:
        fw = self.framework.name if self.framework else "unknown"
        return f"{fw}_{self.NAME}"

    def register_priority_var(self) -> None:
        mca_var.register(
            self._prefix() + "_priority", "int", self.PRIORITY,
            f"Selection priority of the {self.NAME} component of the "
            f"{self.framework.name if self.framework else '?'} framework",
        )


class Framework:
    """One framework: a fixed interface + a set of registered components."""

    def __init__(self, name: str, description: str = "") -> None:
        self.name = name
        self.description = description
        self._components: Dict[str, Component] = {}
        self._opened = False
        # stream name == framework name so the registered
        # ``<name>_verbose`` variable is the one the stream reads
        self._log = output.stream(name)
        mca_var.register(
            name, "str", "",
            f"Comma list of {name} components to include "
            f"(prefix with ^ to exclude instead)",
        )
        mca_var.register(
            f"{name}_verbose", "int", 0,
            f"Verbosity level of the {name} framework",
        )

    # registration -------------------------------------------------------
    def register(self, component: Component) -> Component:
        if component.NAME in self._components:
            return self._components[component.NAME]
        component.framework = self
        self._components[component.NAME] = component
        # if the framework is already open, the new component is opened
        # lazily by available() (respecting the include/exclude filter)
        return component

    def components(self) -> List[Component]:
        return sorted(self._components.values(), key=lambda c: c.NAME)

    def lookup(self, name: str) -> Optional[Component]:
        return self._components.get(name)

    # open/close ---------------------------------------------------------
    def _open_one(self, comp: Component) -> None:
        comp.register_priority_var()
        comp.register_vars()
        try:
            ok = comp.open()
        except Exception as exc:  # a broken plugin must not kill the job
            self._log.verbose(1, f"component {comp.NAME} failed open: {exc}")
            ok = False
        comp.state = ComponentState.OPENED if ok else ComponentState.CLOSED

    def open(self) -> None:
        # only open components passing the include/exclude filter — an
        # excluded component's open() must never run (the user may have
        # excluded it precisely because its open misbehaves). If the
        # selection variable changes later, available() lazily opens
        # newly-included components on demand.
        if self._opened:
            return
        self._opened = True
        for comp in self._filtered():
            self._open_one(comp)

    def close(self) -> None:
        for comp in self._components.values():
            if comp.state is ComponentState.OPENED:
                comp.close()
                comp.state = ComponentState.CLOSED
        self._opened = False

    # selection ----------------------------------------------------------
    def _filtered(self) -> List[Component]:
        """Apply the include/exclude list from the framework variable."""
        spec = (mca_var.get(self.name) or "").strip()
        comps = list(self._components.values())
        if not spec:
            return comps
        if spec.startswith("^"):
            excluded = {s.strip() for s in spec[1:].split(",") if s.strip()}
            return [c for c in comps if c.NAME not in excluded]
        included = [s.strip() for s in spec.split(",") if s.strip()]
        by_name = {c.NAME: c for c in comps}
        missing = [n for n in included if n not in by_name]
        if missing:
            output.show_help(
                "mca", "component-not-found",
                framework=self.name, names=", ".join(missing),
                available=", ".join(sorted(by_name)),
            )
        return [by_name[n] for n in included if n in by_name]

    def available(self, ctx: Any = None) -> List[Tuple[int, Component, Any]]:
        """All opened components whose query succeeds, best first."""
        if not self._opened:
            self.open()
        out: List[Tuple[int, Component, Any]] = []
        for comp in self._filtered():
            if comp.state is ComponentState.REGISTERED:
                self._open_one(comp)  # included after a selection change
            if comp.state is not ComponentState.OPENED:
                continue
            res = comp.query(ctx)
            if res is None:
                continue
            prio, module = res
            out.append((prio, comp, module))
        out.sort(key=lambda t: (-t[0], t[1].NAME))
        return out

    def select(self, ctx: Any = None) -> Any:
        """Highest-priority usable module, or raise (no component found)."""
        avail = self.available(ctx)
        if not avail:
            output.show_help("mca", "no-component", framework=self.name)
            raise RuntimeError(
                f"no usable component in framework {self.name!r}"
            )
        prio, comp, module = avail[0]
        self._log.verbose(
            1, f"selected component {comp.NAME} (priority {prio})"
        )
        return module

    def select_all(self, ctx: Any = None) -> List[Any]:
        return [m for _, _, m in self.available(ctx)]


class _FrameworkRegistry:
    """Process-global framework table (for tpu_info introspection)."""

    def __init__(self) -> None:
        self._frameworks: Dict[str, Framework] = {}
        self._lock = threading.Lock()

    def framework(self, name: str, description: str = "") -> Framework:
        with self._lock:
            fw = self._frameworks.get(name)
            if fw is None:
                fw = Framework(name, description)
                self._frameworks[name] = fw
            return fw

    def all(self) -> List[Framework]:
        with self._lock:
            return [self._frameworks[n] for n in sorted(self._frameworks)]

    def _reset_for_tests(self) -> None:
        with self._lock:
            for fw in self._frameworks.values():
                fw.close()
            self._frameworks.clear()


FRAMEWORKS = _FrameworkRegistry()


def framework(name: str, description: str = "") -> Framework:
    return FRAMEWORKS.framework(name, description)


output.register_help(
    "mca",
    {
        "component-not-found": (
            "Requested {framework} component(s) not found: {names}\n"
            "Available components: {available}"
        ),
        "no-component": (
            "No usable component found for framework {framework!r}; the "
            "job cannot continue."
        ),
    },
)
