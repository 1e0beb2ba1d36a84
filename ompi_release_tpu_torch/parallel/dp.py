"""Data parallelism: bucketed gradient allreduce (counterpart of
``ompi_release_tpu/parallel/dp.py``).

Every dp replica holds a full gradient tree; the replicas psum (or mean)
it. Small leaves fuse into flat buckets (the fusion decision is
``coll.fusion.plan_buckets``, shared with the fusion buffer), so each
bucket is one collective. Two execution modes:

- :func:`allreduce_gradients`: per-rank code inside a mesh
  (``parallel/mesh_axes.py``), one ``psum`` per bucket
  (:func:`parallel.tree.tree_allreduce`);
- :class:`GradientSync`: the host-driver path, one ``iallreduce`` per
  bucket issued up front, caller work overlapping them, ``wait()`` at
  the step boundary (:class:`parallel.tree.TreeSync`).

The flagship train step needs neither: its replicated parameters are
size-1 rank dims of the stacked layout, and autograd's backward of that
broadcast sums the replicas' gradients.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..mca import var as mca_var
from . import axes
from . import tree as _tree_mod


def register_vars() -> None:
    mca_var.register(
        "dp_bucket_bytes", "int", 4 * 1024 * 1024,
        "Gradient-allreduce bucket size in bytes (small leaves are "
        "flattened+concatenated up to this size per collective)",
    )


register_vars()  # idempotent


def allreduce_gradients(grads: Any, axis_name: str, *, mean: bool = True,
                        bucket_bytes: Optional[int] = None) -> Any:
    """Allreduce a gradient tree over the dp axis in one planned pass
    (leaves below ``bucket_bytes`` fused per dtype; None resolves
    through the ``tree_buckets`` rules > ``tree_bucket_bytes`` >
    ``dp_bucket_bytes``)."""
    return _tree_mod.tree_allreduce(grads, axis_name, mean=mean,
                                    bucket_bytes=bucket_bytes)


class GradientSync(_tree_mod.TreeSync):
    """Overlapped gradient-bucket allreduce for the host-driver path:
    the allreduce specialization of :class:`parallel.tree.TreeSync`,
    with ``mean`` on by default. Per step::

        pending = sync.issue(grads)   # one iallreduce per bucket
        ... compute
        new_grads = pending.wait()    # step boundary
    """

    def __init__(self, comm, *, mean: bool = True,
                 bucket_bytes: Optional[int] = None) -> None:
        super().__init__(comm, mean=mean, bucket_bytes=bucket_bytes)


#: the pending handle is the shared tree-pass one
PendingGradSync = _tree_mod.PendingTreePass


def replicate_check(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Debug guard: max |x - x on rank 0| across the dp axis, 0 when the
    replicas agree (the memchecker-style divergence detector)."""
    rank = axes.axis_index(axis_name, x.dim() - axes.lead(x))
    root = axes.psum(torch.where(rank == 0, x, torch.zeros_like(x)),
                     axis_name)
    diff = (x - root).abs()
    n = axes.lead(diff)
    return axes.pmax_nograd(diff.amax(dim=tuple(range(n, diff.dim())))
                     if diff.dim() > n else diff, axis_name)
