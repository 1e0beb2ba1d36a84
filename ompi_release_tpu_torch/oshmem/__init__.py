"""OpenSHMEM layer — the ``oshmem/`` analogue."""

from .shmem import (  # noqa: F401
    ShmemCtx, SymmetricArray, shmem_init, shmem_finalize,
)
