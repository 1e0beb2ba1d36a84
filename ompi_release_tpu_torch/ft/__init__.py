"""Fault tolerance — checkpoint/restart, failure detection, injection,
error management and ULFM (the crs/crcp/snapc/sstore stack plus
sensor/errmgr, SURVEY §5).

Counterpart of ``ompi_release_tpu/ft``: ``Checkpointer`` (crs + snapc +
sstore), ``sensor`` (heartbeat + ft_tester fault injection), ``errmgr``
(restart-from-checkpoint, ULFM shrink/respawn recovery) and ``ulfm``
(the process-local failure picture: job epoch, failed processes,
revoked communicators).
"""

from .checkpoint import Checkpointer  # noqa: F401
from .sensor import Heartbeat, FtTester, resource_usage  # noqa: F401
from .errmgr import (  # noqa: F401
    ErrMgr, recover, run_with_restart, spawn_replacements,
)
from . import ulfm  # noqa: F401
