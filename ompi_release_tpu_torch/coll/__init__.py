"""Collectives: algorithm bodies over rank-stacked tensors, the rank-axis
driver, the coll framework + components, pipelined segmentation."""

from . import spmd
from .base import COLL_FRAMEWORK, OP_NAMES, comm_select

__all__ = ["spmd", "COLL_FRAMEWORK", "OP_NAMES", "comm_select"]
