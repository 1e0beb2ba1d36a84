"""Fault tolerance — checkpoint/restart (the crs/crcp/snapc/sstore stack,
SURVEY §5).

Counterpart of ``ompi_release_tpu/ft``. Ported so far: ``Checkpointer``.
Failure detection, error management and ULFM (``sensor``, ``errmgr``,
``ulfm``) are not ported yet (ROADMAP queue 1 item 15).
"""

from .checkpoint import Checkpointer  # noqa: F401
