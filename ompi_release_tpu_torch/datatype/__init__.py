"""Datatype engine: predefined + derived datatypes and convertors."""

from .datatype import (
    BFLOAT16, BOOL, BYTE, COMPLEX64, DOUBLE, FLOAT, INT8, INT16, INT32,
    INT64, UINT8, UINT16, UINT32, UINT64, Datatype, PREDEFINED,
    DARG_DEFAULT, DIST_BLOCK, DIST_CYCLIC, DIST_NONE,
    create_contiguous, create_darray, create_hindexed,
    create_indexed_block, create_struct,
    create_subarray, create_vector, from_torch_dtype,
)
from .convertor import Convertor

__all__ = [
    "Datatype", "Convertor", "PREDEFINED", "from_torch_dtype",
    "create_contiguous", "create_vector", "create_hindexed",
    "create_indexed_block", "create_struct", "create_subarray",
    "create_darray", "DIST_BLOCK", "DIST_CYCLIC", "DIST_NONE",
    "DARG_DEFAULT",
    "FLOAT", "DOUBLE", "BFLOAT16", "INT8", "INT16", "INT32", "INT64",
    "UINT8", "UINT16", "UINT32", "UINT64", "BYTE", "BOOL", "COMPLEX64",
]
