"""Communicator/group layer (ompi/communicator + ompi/group analogue)."""

from .group import EMPTY, IDENT, SIMILAR, UNDEFINED, UNEQUAL, Group
from .communicator import (
    Communicator, Keyval, clear_comm_registry, create_keyval, free_keyval,
)
from .info import INFO_ENV, INFO_NULL, Info
from .intercomm import Intercommunicator, intercomm_create
from .world import create_world

__all__ = [
    "Group", "EMPTY", "IDENT", "SIMILAR", "UNEQUAL", "UNDEFINED",
    "Communicator", "Keyval", "create_keyval", "free_keyval",
    "clear_comm_registry", "create_world", "Info", "INFO_ENV", "INFO_NULL",
    "Intercommunicator", "intercomm_create",
]
