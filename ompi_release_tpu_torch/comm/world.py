"""WORLD/SELF communicator creation (``ompi_comm_init`` analogue)."""

from __future__ import annotations

from typing import Tuple

from .communicator import Communicator
from .group import Group


def create_world(runtime) -> Tuple[Communicator, Communicator]:
    world_group = Group(range(runtime.world_size))
    world = Communicator(runtime, world_group, name="MPI_COMM_WORLD")
    # COMM_SELF is per-rank; in driver mode one size-1 comm stands in
    # for it — under a unified multi-process world it must hold a LOCAL
    # rank (this process's first), not world rank 0
    self_group = Group([getattr(runtime, "local_rank_offset", 0)])
    comm_self = Communicator(runtime, self_group, name="MPI_COMM_SELF")
    return world, comm_self
