"""ZeRO-style sharded optimizer state over the dp axis (counterpart of
``ompi_release_tpu/parallel/zero.py``).

Gradients are reduce_scattered so each dp rank owns 1/n of them, updates
its shard, and all_gathers fresh parameters: the same bytes as an
allreduce (reduce_scatter + allgather is the ring allreduce), optimizer
memory divided by n. Both legs are planned whole-tree passes
(:mod:`parallel.tree`), bitwise the per-leaf loop (``bucket_bytes=0``).
Per-rank code inside a mesh (``parallel/mesh_axes.py``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..utils import pytree
from . import axes
from . import tree as _tree_mod


def _map(f, tree_):
    leaves, treedef = pytree.flatten(tree_)
    return pytree.unflatten(treedef, [f(x) for x in leaves])


def shard_gradients(grads: Any, axis_name: str, *, mean: bool = True,
                    bucket_bytes: Optional[int] = None) -> Any:
    """reduce_scatter every leaf over dp: the rank's flat shard tree
    (leaf i -> ceil(size/n) elements), one planned pass."""
    return _tree_mod.tree_reduce_scatter(grads, axis_name, mean=mean,
                                         bucket_bytes=bucket_bytes)


def unshard_params(param_shards: Any, shapes: Any, axis_name: str, *,
                   bucket_bytes: Optional[int] = None) -> Any:
    """all_gather each flat shard back to its full (reshaped) leaf, one
    planned pass."""
    return _tree_mod.tree_allgather(param_shards, shapes, axis_name,
                                    bucket_bytes=bucket_bytes)


def shard_like(params: Any, axis_name: str) -> Any:
    """Each leaf's per-rank values flattened, zero-padded to n chunks,
    and this rank's chunk (for building sharded optimizer state)."""
    n = axes.axis_size_or_1(axis_name)

    def sl(p):
        rows = _tree_mod._padded_rows(p, n)  # (..., n, chunk)
        if n == 1:
            return rows[..., 0, :]
        d = axes.current_mesh().axis_dim(axis_name)
        # rank r along the axis keeps chunk r of its own values: the
        # chunk index becomes the axis's rank dim
        if rows.shape[d] == 1:
            return rows.squeeze(d).movedim(-2, d)
        return torch.diagonal(rows, dim1=d, dim2=-2).movedim(-1, d)

    return _map(sl, params)


def zero_step(params: Any, grads: Any, opt_state_shards: Any, opt_update,
              axis_name: str, *,
              bucket_bytes: Optional[int] = None) -> Tuple[Any, Any]:
    """One ZeRO-1 step: shard the gradients, update the owned shard,
    regather; both legs ride the planned tree pass.
    ``opt_update(grad_shards, state_shards, param_shards) -> (updates,
    new_state)`` follows optax's transform signature over the flat-shard
    trees."""
    gshards = shard_gradients(grads, axis_name, bucket_bytes=bucket_bytes)
    pshards = shard_like(params, axis_name)
    updates, new_state = opt_update(gshards, opt_state_shards, pshards)
    pl, treedef = pytree.flatten(pshards)
    new_pshards = pytree.unflatten(
        treedef, [p + u for p, u in zip(pl, pytree.leaves(updates))])
    shapes = _map(lambda p: tuple(p.shape[axes.lead(p):]), params)
    return unshard_params(new_pshards, shapes, axis_name,
                          bucket_bytes=bucket_bytes), new_state
