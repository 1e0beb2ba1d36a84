"""Reduction ops (MPI_Op analogue) + op framework for overrides."""

from .op import (
    BAND, BOR, BXOR, LAND, LOR, LXOR, MAX, MAXLOC, MIN, MINLOC, NO_OP,
    OP_FRAMEWORK, PREDEFINED_OPS, PROD, REPLACE, SUM, Op, reduce_local,
    resolve, user_op,
)
from .cuda_op import CudaOpComponent

OP_FRAMEWORK.register(CudaOpComponent())

__all__ = [
    "Op", "user_op", "PREDEFINED_OPS", "OP_FRAMEWORK", "resolve",
    "reduce_local",
    "SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR",
    "BXOR", "MAXLOC", "MINLOC", "REPLACE", "NO_OP",
]
