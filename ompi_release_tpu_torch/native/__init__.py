"""ctypes bindings for the native control-plane library (built from
the JAX package's ``native/`` sources into the port's own build
directory)."""

from .bindings import (  # noqa: F401
    SECRET_ENV, USER_TAG_BASE, DssBuffer, OobEndpoint, build_library,
    load_library,
)
