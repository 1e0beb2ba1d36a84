"""Parallel I/O — the MPI-IO (romio/ompio) analogue."""

from .file import File, MODE_RDONLY, MODE_WRONLY, MODE_RDWR, MODE_CREATE
from .sharded import (  # noqa: F401
    save_sharded, load_sharded, save_pytree, load_pytree,
)

__all__ = [
    "File", "MODE_RDONLY", "MODE_WRONLY", "MODE_RDWR", "MODE_CREATE",
    "save_sharded", "load_sharded", "save_pytree", "load_pytree",
]
