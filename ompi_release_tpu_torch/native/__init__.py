"""ctypes bindings for the native control-plane library (built from
the JAX package's ``native/`` sources into the port's own build
directory)."""

from .bindings import (  # noqa: F401
    SECRET_ENV, USER_TAG_BASE, DssBuffer, NativeEventRing, OobEndpoint,
    PlanExec, ShmRing, build_library, load_library, planexec_symbols_available,
    telemetry_symbols_available, wire_symbols_available,
)
