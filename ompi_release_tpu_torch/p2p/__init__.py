"""Point-to-point engine — the pml/bml/btl stack over rank-stacked
tensors (counterpart of ``ompi_release_tpu/p2p``).

Two paths:

- ``spmd``: static schedules as one index gather over the rank axis —
  the path for fixed communication patterns (rings, halos);
- ``pml``: MPI dynamic semantics — (rank, tag, comm) matching with
  wildcards, unexpected-message queue, eager/rendezvous/pipelined
  transfer scheduling — executed as host-orchestrated device copies.
"""

from . import pml, spmd  # noqa: F401
from .pml import (  # noqa: F401
    ANY_SOURCE, ANY_TAG, PmlEngine,
)
