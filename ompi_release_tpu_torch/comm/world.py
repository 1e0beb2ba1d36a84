"""WORLD/SELF communicator creation (``ompi_comm_init`` analogue)."""

from __future__ import annotations

from typing import Tuple

from .communicator import Communicator
from .group import Group


def create_world(runtime) -> Tuple[Communicator, Communicator]:
    world_group = Group(range(runtime.world_size))
    world = Communicator(runtime, world_group, name="MPI_COMM_WORLD")
    # COMM_SELF is per-rank; in driver mode one size-1 comm stands in
    comm_self = Communicator(runtime, Group([0]), name="MPI_COMM_SELF")
    return world, comm_self
