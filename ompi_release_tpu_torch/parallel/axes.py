"""The axis collectives of the per-rank code, over the stacked layout.

The ``lax`` collectives the JAX package's ``parallel/`` and models call
inside ``shard_map``, for values laid out as ``parallel/mesh_axes.py``
says (the bound mesh's axes as leading dims, then the rank's dims):

- :func:`psum` / :func:`pmean` over one axis or a tuple of axes fold
  along those leading dims in JAX's order: linear in rank order, the
  tuple's first axis outermost (``lax.psum`` on the CPU sums
  ``((r0 + r1) + r2) + ...``). The result is invariant over the axes:
  those leading dims come back with size 1. Each add is the resolved
  SUM op (``ops.op.resolve``), so a large f32/bf16 fold launches the
  CUDA streaming kernel. bf16 folds of more than two ranks accumulate in
  f32 and round once, as XLA's CPU all-reduce does (its f16 ones round
  every add, as here); two ranks round once either way.
- :func:`vary` is the conjugate: an invariant value used where the
  ranks differ (Megatron's ``f``, the ``pvary`` JAX's replication
  tracking inserts). Forward it broadcasts; backward it folds the
  ranks' cotangents with :func:`psum`'s fold. Both are
  ``torch.autograd.Function``s: the kernel has no backward of its own.
- :func:`pmax_nograd` is ``_pmax_nograd`` (a max with no gradient; also
  ``lax.pmax``, which has no differentiation rule).
- :func:`all_gather`, :func:`psum_scatter` (tiled or not),
  :func:`all_to_all` (tiled or not) and :func:`ppermute` are moves,
  reshapes and gathers along the axis's leading dim; autograd
  differentiates them.
- :func:`axis_index` is the rank's index along an axis,
  ``axis_size_or_1`` its size.

Every function is the identity (or the index 0) when the axis has size
1 or no mesh is bound, so layer code runs unchanged on one rank. Per-rank
dim arguments (``axis``, ``split_axis``, ...) count the rank's own dims,
as in JAX.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from ..coll import spmd as _spmd
from ..ops import op as _op
from .mesh_axes import (  # noqa: F401
    ParallelMesh, axis_size_or_1, current_mesh,
)

Axes = Union[str, Sequence[str]]

#: dtypes whose folds of > 2 ranks accumulate in f32 (XLA's CPU
#: all-reduce widens bf16, not f16)
_NARROW = (torch.bfloat16,)


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _wide(axes: Axes) -> Tuple[ParallelMesh, Tuple[str, ...]]:
    """(bound mesh, the axes of size > 1 in ``axes``' order); the mesh is
    None when nothing is bound."""
    mesh = current_mesh()
    if mesh is None:
        return None, ()
    return mesh, tuple(a for a in _names(axes) if mesh.axis_size_or_1(a) > 1)


def axis_index(axis_name: str, ndim: int = 0):
    """``lax.axis_index(axis_name)`` shaped to broadcast against per-rank
    values of ``ndim`` dims; the int 0 when the axis has size 1."""
    mesh = current_mesh()
    if mesh is None or mesh.axis_size_or_1(axis_name) == 1:
        return 0
    return mesh.axis_index(axis_name, ndim)


def lead(x: torch.Tensor) -> int:
    """How many leading rank dims the bound mesh gives ``x`` (0 unbound)."""
    mesh = current_mesh()
    return 0 if mesh is None else mesh.lead


def align(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``t`` (stacked, or with no rank dims) viewed with ``ndim`` per-rank
    dims: size-1 dims go in right after the leading rank dims, so it
    broadcasts against per-rank values of ``ndim`` dims (torch aligns
    dims from the right, which would misplace the rank dims)."""
    mesh = current_mesh()
    if mesh is None or t.dim() < mesh.lead:
        return t
    k = t.dim() - mesh.lead
    if k >= ndim:
        return t
    return t.reshape(t.shape[:mesh.lead] + (1,) * (ndim - k)
                     + t.shape[mesh.lead:])


def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` per rank, for ``x`` (..., K) of any per-rank rank and
    ``w`` a per-rank (K, N) matrix: ``x``'s per-rank batch dims fold
    into its rows, so the ranks' products are one batched GEMM."""
    mesh = current_mesh()
    if mesh is None:
        return torch.matmul(x, w)
    n = mesh.lead
    rows = x.reshape(x.shape[:n] + (-1, x.shape[-1]))
    return torch.matmul(rows, w).reshape(
        torch.broadcast_shapes(x.shape[:n], w.shape[:n])
        + x.shape[n:-1] + (w.shape[-1],))


# ---------------------------------------------------------------------------
# psum and its conjugate
# ---------------------------------------------------------------------------

def _fold(x: torch.Tensor, dims: Tuple[int, ...],
          sizes: Tuple[int, ...]) -> torch.Tensor:
    """Sum ``x`` over the leading ``dims`` (sizes ``sizes``; a dim of
    size 1 is a value every rank holds, counted ``size`` times) in rank
    order, the first dim outermost; returns those dims at size 1."""
    full = list(x.shape)
    for d, n in zip(dims, sizes):
        full[d] = n
    g = x.expand(full)
    rest = [d for d in range(g.dim()) if d not in dims]
    g = g.permute(list(dims) + rest).reshape(
        (math.prod(sizes),) + tuple(full[d] for d in rest))
    narrow = g.dtype in _NARROW and g.shape[0] > 2
    if narrow:
        g = g.float()
    op = _op.resolve(_op.SUM, g.dtype, g[0].numel() * g.element_size())
    acc = g[0]
    for i in range(1, g.shape[0]):
        acc = op(acc, g[i])
    if narrow:
        acc = acc.to(x.dtype)
    out = list(full)
    for d in dims:
        out[d] = 1
    return acc.reshape(out)


class _Psum(torch.autograd.Function):
    """psum: the fold forward; backward the cotangent broadcast back to
    every rank (the invariant result's transpose, JAX's ``pvary``)."""

    @staticmethod
    def forward(ctx, x, dims, sizes):
        ctx.shape = x.shape
        return _fold(x, dims, sizes)

    @staticmethod
    def backward(ctx, g):
        # a rank dim x held at size 1 (invariant) was counted once per
        # rank: its cotangent is the sum of the copies
        full = list(g.shape)
        for d in range(len(full)):
            full[d] = max(full[d], ctx.shape[d])
        return g.expand(full).sum_to_size(ctx.shape), None, None


class _Vary(torch.autograd.Function):
    """vary: broadcast forward; backward the ranks' cotangents folded by
    :func:`_fold` (psum, the transpose of the broadcast)."""

    @staticmethod
    def forward(ctx, x, dims, sizes):
        ctx.dims, ctx.sizes = dims, sizes
        full = list(x.shape)
        for d, n in zip(dims, sizes):
            full[d] = n
        return x.expand(full)

    @staticmethod
    def backward(ctx, g):
        return _fold(g.contiguous(), ctx.dims, ctx.sizes), None, None


def psum(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """``lax.psum`` over ``axis_name`` (one name or a tuple)."""
    mesh, wide = _wide(axis_name)
    if not wide:
        return x
    dims = tuple(mesh.axis_dim(a) for a in wide)
    return _Psum.apply(x, dims, tuple(mesh.shape[a] for a in wide))


def pmean(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """``lax.pmean``: :func:`psum` divided by the ranks summed over."""
    mesh, wide = _wide(axis_name)
    if not wide:
        return x
    return psum(x, wide) / math.prod(mesh.shape[a] for a in wide)


def vary(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """An invariant value made varying over ``axis_name`` (identity
    forward; the cotangents psum'd backward). Dims already varying stay
    as they are."""
    mesh, wide = _wide(axis_name)
    wide = tuple(a for a in wide if x.shape[mesh.axis_dim(a)] == 1)
    if not wide or x.dim() < mesh.lead:
        return x
    return _Vary.apply(x, tuple(mesh.axis_dim(a) for a in wide),
                       tuple(mesh.shape[a] for a in wide))


def pmax_nograd(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """``_pmax_nograd``: the max over the axes, carrying no gradient."""
    mesh, wide = _wide(axis_name)
    x = x.detach()
    if not wide:
        return x
    return x.amax(dim=tuple(mesh.axis_dim(a) for a in wide), keepdim=True)


# ---------------------------------------------------------------------------
# data movement
# ---------------------------------------------------------------------------

def _full_at(x: torch.Tensor, d: int, n: int) -> torch.Tensor:
    if x.shape[d] == n:
        return x
    full = list(x.shape)
    full[d] = n
    return x.expand(full)


def _per_rank(mesh: ParallelMesh, x: torch.Tensor, axis: int) -> int:
    k = x.dim() - mesh.lead
    if not -k <= axis < k:
        raise ValueError(f"axis {axis} out of range for a per-rank value "
                         f"of {k} dims")
    return axis % k


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x`` stacked (or, ``tiled``,
    concatenated) along per-rank dim ``axis`` in rank order; the result
    is invariant over the axis."""
    mesh, wide = _wide(axis_name)
    if not wide:
        return x.unsqueeze(lead(x) + axis) if not tiled and \
            axis >= 0 else x
    d, n = mesh.axis_dim(axis_name), mesh.shape[axis_name]
    a = _per_rank(mesh, x, axis)
    p = mesh.lead + a  # where the rank dim lands among the rank's dims
    y = _full_at(x, d, n).movedim(d, p - 1).unsqueeze(d)
    if not tiled:
        return y
    return y.reshape(y.shape[:p] + (n * y.shape[p + 1],) + y.shape[p + 2:])


def psum_scatter(x: torch.Tensor, axis_name: str, *,
                 scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """``lax.psum_scatter``: the :func:`psum` of ``x`` with rank r keeping
    block r of per-rank dim ``scatter_dimension`` (tiled: n equal
    blocks; not tiled: the dim has size n and is dropped)."""
    mesh, wide = _wide(axis_name)
    if not wide:
        return x if tiled else x.squeeze(lead(x) + scatter_dimension)
    d, n = mesh.axis_dim(axis_name), mesh.shape[axis_name]
    a = _per_rank(mesh, x, scatter_dimension)
    s = psum(x, axis_name).squeeze(d)  # the rank dims less d
    p = mesh.lead - 1 + a
    if tiled:
        if s.shape[p] % n:
            raise ValueError(f"psum_scatter: dim of size {s.shape[p]} does "
                             f"not split into {n} blocks")
        s = s.reshape(s.shape[:p] + (n, s.shape[p] // n) + s.shape[p + 1:])
    elif s.shape[p] != n:
        raise ValueError(f"psum_scatter: dim of size {s.shape[p]} != axis "
                         f"size {n}")
    return s.movedim(p, d)


def all_to_all(x: torch.Tensor, axis_name: str, *, split_axis: int,
               concat_axis: int, tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all``: rank r's block j of per-rank dim ``split_axis``
    goes to rank j, which concatenates the blocks it receives in rank
    order along ``concat_axis`` (tiled), or (not tiled: ``split_axis``
    has size n) drops ``split_axis`` and stacks them as a new dim at
    ``concat_axis``."""
    mesh, wide = _wide(axis_name)
    if not wide:
        return x
    d, n = mesh.axis_dim(axis_name), mesh.shape[axis_name]
    k = x.dim() - mesh.lead
    sa, ca = split_axis % k, concat_axis % k
    x = _full_at(x, d, n)
    if tiled:
        p = mesh.lead + sa
        if x.shape[p] % n:
            raise ValueError(f"all_to_all: dim of size {x.shape[p]} does "
                             f"not split into {n} blocks")
        x = x.reshape(x.shape[:p] + (n, x.shape[p] // n) + x.shape[p + 1:])
    elif x.shape[mesh.lead + sa] != n:
        raise ValueError(f"all_to_all: split dim of size "
                         f"{x.shape[mesh.lead + sa]} != axis size {n}")
    # swap the source-rank dim with the block dim: the leading dim now
    # names the destination, the block dim the source
    y = x.transpose(d, mesh.lead + sa).movedim(mesh.lead + sa,
                                               mesh.lead + ca)
    if not tiled:
        return y
    p = mesh.lead + ca
    return y.reshape(y.shape[:p] + (n * y.shape[p + 1],) + y.shape[p + 2:])


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` along the axis: rank ``src``'s value goes to rank
    ``dst`` for each pair; a rank that receives nothing gets zeros."""
    mesh, wide = _wide(axis_name)
    if not wide:
        return x
    d, n = mesh.axis_dim(axis_name), mesh.shape[axis_name]
    y = _full_at(x, d, n).movedim(d, 0)
    return _spmd.ppermute(y, list(perm)).movedim(0, d)
