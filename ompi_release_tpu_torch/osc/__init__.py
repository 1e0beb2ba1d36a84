"""One-sided communication (RMA) — the ``ompi/mca/osc`` analogue."""

from .window import (  # noqa: F401
    DynamicWindow, Window, win_create, win_allocate,
    win_allocate_shared, win_create_dynamic,
    LOCK_EXCLUSIVE, LOCK_SHARED,
)
