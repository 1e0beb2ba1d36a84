"""Parallelism strategies of the flagship model, single-card half.

Counterpart of ``ompi_release_tpu/parallel``. This slice ports what the
model family runs on one card, where every mesh axis has size 1: the
mesh conventions (``mesh_axes``), the tensor-parallel linear layers,
embedding and loss at tp = 1 (``tp``), ring attention at sp = 1 (``cp``),
the one-stage pipeline (``pp``) and the switch-MoE layer at ep = 1
(``ep``). The collectives of axes > 1 come with the multi-card slice.
"""

from . import cp, ep, pp, tp  # noqa: F401
from .mesh_axes import (  # noqa: F401
    AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, CANONICAL_ORDER,
    ParallelMesh, build_parallel_mesh,
)
