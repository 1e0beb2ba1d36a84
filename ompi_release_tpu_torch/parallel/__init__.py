"""Parallelism strategies (counterpart of ``ompi_release_tpu/parallel``).

Each strategy is built on the communication pattern the reference
provides for it, over the stacked-rank layout of ``mesh_axes`` (every
rank of a mesh a virtual rank of one device, a per-rank value one tensor
with the mesh axes as leading dims) and the axis collectives of
``axes``:

  DP   — bucketed gradient allreduce (``dp``, over ``tree``)
  TP   — sharded matmuls + psum/all_gather (``tp``)
  PP   — the GPipe ppermute ring and the host-driven schedule (``pp``)
  SP   — Ulysses head <-> sequence all-to-all (``sp``)
  CP   — ring attention: K/V blocks rotating over sp (``cp``)
  EP   — expert token routing over all-to-all (``ep``)
  ZeRO — reduce_scatter gradient / optimizer sharding (``zero``)

``elastic`` drives a train step through a rank's death: detect, revoke,
recover (shrink or respawn), roll back to the agreed checkpoint.
"""

from . import axes, cp, dp, elastic, ep, pp, sp, tp, tree, zero  # noqa: F401
from .mesh_axes import (  # noqa: F401
    AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, CANONICAL_ORDER, P,
    ParallelMesh, PartitionSpec, axis_size_or_1, build_parallel_mesh,
)
from .tree import (  # noqa: F401
    TreeSync, match_partition_rules, named_tree_map, tree_allgather,
    tree_allreduce, tree_reduce_scatter,
)
