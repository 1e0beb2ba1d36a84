"""Communicator/group layer (ompi/communicator + ompi/group analogue)."""

from .group import EMPTY, IDENT, SIMILAR, UNDEFINED, UNEQUAL, Group
from .communicator import (
    Communicator, Keyval, clear_comm_registry, create_keyval, free_keyval,
)
from .info import INFO_ENV, INFO_NULL, Info
from .intercomm import Intercommunicator, intercomm_create
from .dpm import (
    close_port, comm_accept, comm_connect, lookup_name, open_port,
    publish_name, unpublish_name,
)
from .spawn import SpawnedJob, comm_spawn
from .world import create_world

__all__ = [
    "Group", "EMPTY", "IDENT", "SIMILAR", "UNEQUAL", "UNDEFINED",
    "Communicator", "Keyval", "create_keyval", "free_keyval",
    "clear_comm_registry", "create_world", "Info", "INFO_ENV", "INFO_NULL",
    "Intercommunicator", "intercomm_create",
    "SpawnedJob", "comm_spawn",
    "open_port", "close_port", "publish_name", "unpublish_name",
    "lookup_name", "comm_accept", "comm_connect",
]
