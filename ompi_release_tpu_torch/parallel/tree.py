"""Pytree-native planned collectives: one fused pass over whole
parameter trees (counterpart of ``ompi_release_tpu/parallel/tree.py``,
the in-process half).

rules -> plan
    :func:`match_partition_rules` turns regex rules into a
    ``PartitionSpec`` tree (first match wins, single-element leaves never
    partitioned, an unmatched leaf raises). :func:`plan_tree` buckets
    the leaves per dtype through the one shared fusion planner
    (:func:`coll.fusion.plan_buckets`) and caches the plan per tree
    signature.

SPMD pass (per-rank code inside a mesh, ``parallel/mesh_axes.py``)
    :func:`tree_allreduce` / :func:`tree_reduce_scatter` /
    :func:`tree_allgather`: one ``psum`` / ``psum_scatter`` /
    ``all_gather`` per bucket instead of one per leaf. ``bucket_bytes=0``
    is the per-leaf path; the planned path is bitwise-identical to it
    (buckets pack a rank-major interleaved layout, and every fold is
    elementwise in one fixed rank order). Leaf signatures are per rank:
    a stacked leaf's shape less its rank dims.

driver pass
    :class:`TreeSync`: one nonblocking collective per bucket issued up
    front on a communicator (leaves in the driver convention, leading
    axis = member ranks), the caller's work overlapping them, ``wait()``
    at the step boundary (``parallel/dp.GradientSync`` is the allreduce
    specialization). :func:`run_tree_pass` runs a whole planned SPMD
    pass as one cached program of the comm (``coll/driver.py``).

Bucket sizing: explicit argument > ``tree_buckets`` dynamic rule lines
(the 5th column is the bucket size, the algorithm ``fused`` or
``per_leaf``) > ``tree_bucket_bytes`` cvar > ``dp_bucket_bytes``.

pvars: ``tree_buckets_planned``, ``tree_plan_cache_hits`` (1 = hit, 0 =
build), ``tree_passes``, ``tree_hidden_seconds``. The journal spans the
reference records wait for the port's observability layer.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coll.fusion import plan_buckets
from ..mca import pvar
from ..mca import var as mca_var
from ..utils import pytree
from . import axes
from .mesh_axes import PartitionSpec

_buckets_planned = pvar.counter(
    "tree_buckets_planned",
    "fused buckets produced by tree-collective plan builds "
    "(big per-leaf transfers count as their own bucket)",
)
_plan_hits = pvar.aggregate(
    "tree_plan_cache_hits",
    "tree-plan cache outcome per planned pass (1=hit, 0=build); "
    "sum/count = hit ratio",
)
_passes = pvar.counter(
    "tree_passes",
    "whole-tree planned DRIVER passes issued (TreeSync)",
)
_hidden = pvar.timer(
    "tree_hidden_seconds",
    "tree-pass collective time that ran while the caller computed "
    "(per-schedule progress-engine accounting, summed at wait())",
)


def register_vars() -> None:
    mca_var.register(
        "tree_bucket_bytes", "size", 0,
        "Bucket capacity in bytes for planned whole-tree collectives "
        "(leaves below it fuse per dtype, at/above it transfer "
        "individually); 0 = defer to tree_buckets dynamic rules, "
        "then dp_bucket_bytes",
    )


register_vars()  # idempotent; cvars must exist before the first plan


# ---------------------------------------------------------------------------
# regex partition rules -> PartitionSpec tree
# ---------------------------------------------------------------------------

def _paths(tree_: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) in ``jax.tree.flatten``'s order: dict keys
    sorted, sequence indices, None a node with no leaves."""
    if isinstance(tree_, dict):
        return [p for k in sorted(tree_)
                for p in _paths(tree_[k], prefix + (k,))]
    if isinstance(tree_, (list, tuple)) and \
            not isinstance(tree_, PartitionSpec):
        return [p for i, c in enumerate(tree_)
                for p in _paths(c, prefix + (i,))]
    if tree_ is None:
        return []
    return [(prefix, tree_)]


def tree_path_str(path: Sequence, sep: str = "/") -> str:
    """A key path as the ``sep``-joined name regex rules match."""
    return sep.join(str(k) for k in path)


def named_tree_map(f, tree_, *, sep: str = "/"):
    """``jax.tree.map`` with the leaf's path name as first argument."""
    pairs = _paths(tree_)
    _, treedef = pytree.flatten(tree_)
    return pytree.unflatten(
        treedef, [f(tree_path_str(p, sep), x) for p, x in pairs])


def is_scalar_leaf(leaf) -> bool:
    """Scalar (or single-element) leaves are never partitioned."""
    shape = tuple(getattr(leaf, "shape", ()))
    return len(shape) == 0 or math.prod(shape) == 1


def match_partition_rules(rules: Sequence[Tuple[str, Any]], tree_, *,
                          sep: str = "/"):
    """``PartitionSpec`` tree from ``[(regex, spec)]`` rules matched
    against each leaf's path name (first match wins; scalar leaves get
    ``P()`` regardless). Raises ``ValueError`` naming the leaf when no
    rule matches."""
    def pick(name, leaf):
        if is_scalar_leaf(leaf):
            return PartitionSpec()
        for pat, spec in rules:
            if re.search(pat, name) is not None:
                return spec
        raise ValueError(f"no partition rule matches leaf {name!r}")

    return named_tree_map(pick, tree_, sep=sep)


# ---------------------------------------------------------------------------
# the plan: per-dtype buckets over leaf metadata, cached per signature
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt)) if not isinstance(dt, str) else dt


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


class TreePlan:
    """One planned pass over a tree signature: which leaves transfer
    alone (``big``) and which fuse into which bucket (``buckets``, index
    lists in leaf order, one dtype per bucket)."""

    __slots__ = ("meta", "big", "buckets", "bucket_bytes", "total_bytes")

    def __init__(self, meta, big, buckets, bucket_bytes, total_bytes):
        self.meta = meta  # ((shape, dtype_str, size, nbytes), ...)
        self.big = big
        self.buckets = buckets
        self.bucket_bytes = bucket_bytes
        self.total_bytes = total_bytes

    def n_transfers(self) -> int:
        return len(self.big) + len(self.buckets)


_plans: Dict[Tuple, TreePlan] = {}
_plans_lock = threading.Lock()


def _meta_of(shapes_dtypes) -> Tuple:
    meta = []
    for shape, dt in shapes_dtypes:
        shape = tuple(int(d) for d in shape)
        size = math.prod(shape)
        name = _dtype_name(dt)
        meta.append((shape, name, size, size * _itemsize(name)))
    return tuple(meta)


def plan_from_meta(shapes_dtypes: Sequence[Tuple[Tuple, Any]],
                   bucket_bytes: int) -> TreePlan:
    """Build (or fetch) the plan for a sequence of ``(shape, dtype)``
    leaf signatures (dtypes as torch dtypes, numpy dtypes or names).
    Pure metadata."""
    meta = _meta_of(shapes_dtypes)
    key = (meta, int(bucket_bytes))
    with _plans_lock:
        plan = _plans.get(key)
    if plan is not None:
        _plan_hits.observe(1)
        return plan
    _plan_hits.observe(0)
    big: List[int] = []
    small: List[Tuple[int, int, str]] = []
    for i, (_shape, dt, _size, nbytes) in enumerate(meta):
        if bucket_bytes > 0 and nbytes < bucket_bytes:
            small.append((i, nbytes, dt))
        else:
            big.append(i)
    buckets = plan_buckets(iter(small), bucket_bytes)
    _buckets_planned.add(len(big) + len(buckets))
    plan = TreePlan(meta, big, buckets, int(bucket_bytes),
                    sum(m[3] for m in meta))
    with _plans_lock:
        _plans[key] = plan
    return plan


def _rank_shape(leaf: torch.Tensor) -> Tuple[int, ...]:
    return tuple(leaf.shape[axes.lead(leaf):])


def plan_tree(tree_, bucket_bytes: Optional[int] = None,
              comm_size: int = 0) -> Tuple[TreePlan, Any, List[Any]]:
    """Flatten ``tree_`` and plan it over its per-rank leaf signatures;
    returns (plan, treedef, leaves). ``bucket_bytes=None`` resolves
    through rules and cvars (:func:`resolve_bucket_bytes`); ``0`` forces
    the per-leaf path."""
    leaves, treedef = pytree.flatten(tree_)
    sigs = [(_rank_shape(l), l.dtype) for l in leaves]
    if bucket_bytes is None:
        total = sum(m[3] for m in _meta_of(sigs))
        bucket_bytes = resolve_bucket_bytes(comm_size, total)
    return plan_from_meta(sigs, bucket_bytes), treedef, leaves


def resolve_bucket_bytes(comm_size: int, tree_bytes: int) -> int:
    """Bucket capacity for a planned pass, in tuned precedence order:
    ``tree_buckets`` dynamic rule (algorithm ``per_leaf`` -> 0, else the
    rule's 5th column) > ``tree_bucket_bytes`` cvar > ``dp_bucket_bytes``
    cvar. ``comm_size`` / ``tree_bytes`` are the rule-match keys."""
    from ..coll import dynamic_rules
    from . import dp as _dp

    _dp.register_vars()
    alg = dynamic_rules.lookup("tree_buckets", comm_size, tree_bytes)
    if alg == "per_leaf":
        return 0
    if alg == "fused":
        seg = dynamic_rules.lookup_segsize("tree_buckets", comm_size,
                                           tree_bytes)
        if seg is not None:
            return int(seg)
    v = int(mca_var.get("tree_bucket_bytes", 0))
    if v > 0:
        return v
    return int(mca_var.get("dp_bucket_bytes", 4 * 1024 * 1024))


# ---------------------------------------------------------------------------
# SPMD planned passes (per-rank code inside a mesh)
# ---------------------------------------------------------------------------

def _chunk(size: int, n: int) -> int:
    return -(-size // n)  # ceil(size / n)


def _maybe_mean(x: torch.Tensor, n: int, mean: bool) -> torch.Tensor:
    return x / n if mean and (x.is_floating_point() or x.is_complex()) \
        else x


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    """The leaf's per-rank values as one dim."""
    n = axes.lead(leaf)
    return leaf.reshape(leaf.shape[:n] + (-1,))


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate along the last dim, rank dims broadcast to agree."""
    n = axes.lead(parts[0])
    ranks = torch.broadcast_shapes(*(p.shape[:n] for p in parts))
    return torch.cat([p.expand(ranks + p.shape[n:]) for p in parts], dim=-1)


def tree_allreduce(tree_, axis_name: str, *, mean: bool = False,
                   bucket_bytes: Optional[int] = None):
    """Allreduce every leaf over ``axis_name`` in one planned pass: one
    ``psum`` per bucket or big leaf. Bitwise-identical to the per-leaf
    loop (``bucket_bytes=0``): packing is pure layout."""
    n = axes.axis_size_or_1(axis_name)
    plan, treedef, leaves = plan_tree(tree_, bucket_bytes, n)
    out: List[Any] = [None] * len(leaves)
    for i in plan.big:
        out[i] = _maybe_mean(axes.psum(leaves[i], axis_name), n, mean)
    for bucket in plan.buckets:
        red = axes.psum(_cat([_flat(leaves[i]) for i in bucket]), axis_name)
        off = 0
        for i in bucket:
            shape, size = plan.meta[i][0], plan.meta[i][2]
            piece = red[..., off:off + size]
            out[i] = _maybe_mean(piece.reshape(piece.shape[:-1] + shape),
                                 n, mean)
            off += size
    return pytree.unflatten(treedef, out)


def _padded_rows(leaf: torch.Tensor, n: int) -> torch.Tensor:
    """The leaf's per-rank values flattened, zero-padded to n equal
    chunks, as (..., n, chunk): chunk r is what rank r owns after a
    tiled scatter."""
    flat = _flat(leaf)
    pad = (-flat.shape[-1]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    return flat.reshape(flat.shape[:-1] + (n, -1))


def tree_reduce_scatter(tree_, axis_name: str, *, mean: bool = True,
                        bucket_bytes: Optional[int] = None):
    """reduce_scatter every leaf over ``axis_name`` in one planned pass;
    returns the per-leaf flat shard tree (leaf i -> ceil(size/n)
    elements per rank). Buckets pack the rank-major interleaved layout,
    so the fused ``psum_scatter`` hands every element to the same rank
    the per-leaf scatter would: bitwise."""
    n = axes.axis_size_or_1(axis_name)
    plan, treedef, leaves = plan_tree(tree_, bucket_bytes, n)
    out: List[Any] = [None] * len(leaves)

    def rs(rows):
        flat = rows.reshape(rows.shape[:-2] + (-1,))
        return axes.psum_scatter(flat, axis_name, scatter_dimension=-1,
                                 tiled=True)

    for i in plan.big:
        out[i] = _maybe_mean(rs(_padded_rows(leaves[i], n)), n, mean)
    for bucket in plan.buckets:
        red = rs(_cat([_padded_rows(leaves[i], n) for i in bucket]))
        off = 0
        for i in bucket:
            c = _chunk(plan.meta[i][2], n)
            out[i] = _maybe_mean(red[..., off:off + c], n, mean)
            off += c
    return pytree.unflatten(treedef, out)


def tree_allgather(shards, shapes, axis_name: str, *,
                   bucket_bytes: Optional[int] = None):
    """all_gather every flat shard back to its full (reshaped) leaf in
    one planned pass. ``shapes`` mirrors ``shards``' structure with
    target per-rank shapes as leaves (tuples). Pure data movement:
    bitwise by construction."""
    n = axes.axis_size_or_1(axis_name)
    plan, treedef, leaves = plan_tree(shards, bucket_bytes, n)
    shape_list = _shape_leaves(shapes, len(leaves))
    out: List[Any] = [None] * len(leaves)

    def ag(shard):
        return axes.all_gather(shard, axis_name, axis=-1, tiled=True)

    def finish(i, full_flat):
        shape = tuple(shape_list[i])
        size = math.prod(shape)
        piece = full_flat[..., :size]
        out[i] = piece.reshape(piece.shape[:-1] + shape)

    for i in plan.big:
        finish(i, ag(leaves[i]))
    for bucket in plan.buckets:
        packed = _cat([leaves[i] for i in bucket])  # (..., C)
        rows = ag(packed)
        rows = rows.reshape(rows.shape[:-1] + (n, -1))  # (..., n, C)
        off = 0
        for i in bucket:
            c = leaves[i].shape[-1]
            piece = rows[..., off:off + c]
            finish(i, piece.reshape(piece.shape[:-2] + (-1,)))
            off += c
    return pytree.unflatten(treedef, out)


def _shape_leaves(shapes, count: int) -> List[Tuple[int, ...]]:
    """The target shapes in leaf order (a shape is a tuple leaf, or a
    single shape for a one-leaf tree)."""
    if isinstance(shapes, tuple) and all(isinstance(d, int)
                                         for d in shapes):
        return [shapes] * count

    def walk(t):
        if isinstance(t, dict):
            return [s for k in sorted(t) for s in walk(t[k])]
        if isinstance(t, list) or (isinstance(t, tuple) and not all(
                isinstance(d, int) for d in t)):
            return [s for c in t for s in walk(c)]
        return [tuple(t)]

    return walk(shapes)


# ---------------------------------------------------------------------------
# one cached program for a whole pass on a communicator
# ---------------------------------------------------------------------------

def run_tree_pass(comm, tree_, *, kind: str = "allreduce",
                  mean: bool = False, bucket_bytes: Optional[int] = None):
    """Run a whole planned tree pass as ONE cached program of a
    host-driver communicator (leaves follow the driver convention:
    leading axis == comm.size): the body, every bucket's pack,
    collective and unpack, is cached per (kind, plan signature) in the
    comm's program cache (``coll/driver.run_sharded``) and its folds run
    over the comm's ranks as one axis. ``kind``: ``allreduce`` returns
    the reduced tree; ``reduce_scatter`` the per-leaf flat shard tree.
    Bitwise-identical to the per-leaf and planned SPMD paths (the body
    IS :func:`tree_allreduce` / :func:`tree_reduce_scatter`)."""
    from ..coll import driver as _driver
    from .mesh_axes import ParallelMesh

    if kind not in ("allreduce", "reduce_scatter"):
        raise ValueError(f"run_tree_pass kind {kind!r} not in "
                         "('allreduce', 'reduce_scatter')")
    leaves, treedef = pytree.flatten(tree_)
    if not leaves:
        return tree_
    leaves = [_driver.as_rank_buffer(l, comm.device) for l in leaves]
    if bucket_bytes is None:
        total = sum(math.prod(l.shape[1:]) * l.element_size()
                    for l in leaves)
        bucket_bytes = resolve_bucket_bytes(comm.size, total)
    # plan over the PER-RANK leaf signatures (leading axis stripped)
    plan = plan_from_meta([(l.shape[1:], l.dtype) for l in leaves],
                          int(bucket_bytes))
    key = ("tree", kind, bool(mean), int(bucket_bytes), plan.meta)
    mesh = ParallelMesh(shape={"rank": comm.size}, device=comm.device)
    fn = tree_allreduce if kind == "allreduce" else tree_reduce_scatter

    def body(*blocks):
        with mesh:
            out = fn(pytree.unflatten(treedef, list(blocks)), "rank",
                     mean=mean, bucket_bytes=int(bucket_bytes))
        return tuple(pytree.leaves(out))

    outs = _driver.run_sharded(comm, key, body, leaves[0],
                               extra_arrays=tuple(leaves[1:]))
    return pytree.unflatten(treedef, list(outs))


# ---------------------------------------------------------------------------
# driver pass: one nonblocking collective per bucket, overlapped
# ---------------------------------------------------------------------------

def _op_hidden_seconds(req) -> float:
    """The progress engine's accounting of how much of this schedule's
    run the caller spent elsewhere (0 for in-process requests)."""
    op = getattr(req, "_sched_op", None)
    return op.hidden_seconds() if op is not None else 0.0


class PendingTreePass:
    """In-flight overlapped tree pass: ``wait()`` completes every bucket,
    folds the engine's hidden-time accounting into
    ``tree_hidden_seconds``, and returns the reassembled tree. Holds leaf
    metadata only."""

    def __init__(self, sync: "TreeSync", kind: str, treedef,
                 plan: TreePlan, reqs: Dict[Any, Any], lead: int,
                 shapes: Optional[List[Tuple]] = None) -> None:
        self._sync = sync
        self._kind = kind  # allreduce | reduce_scatter | allgather
        self._treedef = treedef
        self._plan = plan
        self._reqs = reqs
        self._lead = lead
        self._shapes = shapes  # allgather: target shapes per leaf

    def hidden_seconds(self) -> float:
        return sum(_op_hidden_seconds(r) for r in self._reqs.values())

    def wait(self):
        from ..request import request as _req

        _req.wait_all(list(self._reqs.values()))
        hidden = self.hidden_seconds()
        if hidden > 0:
            _hidden.add(hidden)
        plan, reqs = self._plan, self._reqs
        n, lead = self._sync.comm.size, self._lead
        mean = self._sync.mean
        out: List[Any] = [None] * len(plan.meta)

        def fin(i, t, shape):
            t = t.reshape(shape)
            if mean and self._kind != "allgather":
                t = _maybe_mean(t, n, True)
            out[i] = t

        def val(key):
            return reqs[key].value.reshape(lead, -1)

        if self._kind == "allreduce":
            for i in plan.big:
                fin(i, reqs[("big", i)].value, plan.meta[i][0])
            for k, bucket in enumerate(plan.buckets):
                flat, off = val(("bucket", k)), 0
                for i in bucket:
                    w = plan.meta[i][2] // lead
                    fin(i, flat[:, off:off + w], plan.meta[i][0])
                    off += w
        elif self._kind == "reduce_scatter":
            # values are this member-rank's blocks: (lead, chunk_i)
            for i in plan.big:
                c = _chunk(plan.meta[i][2] // lead, n)
                fin(i, reqs[("big", i)].value, (lead, c))
            for k, bucket in enumerate(plan.buckets):
                flat, off = val(("bucket", k)), 0
                for i in bucket:
                    c = _chunk(plan.meta[i][2] // lead, n)
                    fin(i, flat[:, off:off + c], (lead, c))
                    off += c
        else:  # allgather: rows are (lead, n * C) concatenations
            shapes = self._shapes
            for i in plan.big:
                size = math.prod(shapes[i])
                fin(i, val(("big", i))[:, :size],
                    (lead,) + tuple(shapes[i]))
            for k, bucket in enumerate(plan.buckets):
                bc = sum(plan.meta[i][2] // lead for i in bucket)
                rows = val(("bucket", k)).reshape(lead, n, bc)
                off = 0
                for i in bucket:
                    c = plan.meta[i][2] // lead
                    size = math.prod(shapes[i])
                    piece = rows[:, :, off:off + c].reshape(lead, -1)
                    fin(i, piece[:, :size], (lead,) + tuple(shapes[i]))
                    off += c
        return pytree.unflatten(self._treedef, out)


class TreeSync:
    """Overlapped whole-tree collectives for the host-driver path.

    Buffers follow the communicator's driver convention (leading axis =
    member ranks). One nonblocking collective per plan bucket issues up
    front; the caller computes; ``wait()`` at the step boundary
    reassembles the tree. Bitwise parity with the per-leaf blocking
    path is structural: each bucket runs the collective the blocking
    call would, via the progress engine."""

    def __init__(self, comm, *, mean: bool = False,
                 bucket_bytes: Optional[int] = None) -> None:
        self.comm = comm
        self.mean = mean
        self._bucket_bytes = bucket_bytes

    def _resolve(self, leaves: List[torch.Tensor]) -> int:
        if self._bucket_bytes is not None:
            return int(self._bucket_bytes)
        total = sum(l.numel() * l.element_size() for l in leaves)
        return resolve_bucket_bytes(self.comm.size, total)

    def _flatten(self, tree_) -> Tuple[Any, List[torch.Tensor], int]:
        from ..coll.driver import as_rank_buffer

        leaves_raw, treedef = pytree.flatten(tree_)
        if not leaves_raw or any(np.ndim(l) == 0 for l in leaves_raw):
            raise ValueError(
                "TreeSync needs non-empty driver-mode leaves, each "
                "with a leading (member-slice) axis — 0-d scalar "
                "leaves cannot carry the per-member axis; reshape "
                "them to (lead, 1) or drop them from the pytree")
        leaves = [as_rank_buffer(l, self.comm.device) for l in leaves_raw]
        leads = {l.shape[0] for l in leaves}
        if len(leads) != 1:
            raise ValueError(
                "TreeSync leaves must share one leading "
                f"(member-slice) axis; got leading axes {sorted(leads)}")
        return treedef, leaves, leads.pop()

    def _plan(self, leaves) -> TreePlan:
        return plan_from_meta([(l.shape, l.dtype) for l in leaves],
                              self._resolve(leaves))

    def issue(self, tree_) -> PendingTreePass:
        """Overlapped tree ALLREDUCE: one ``iallreduce`` per bucket;
        returns without completing any of them."""
        treedef, leaves, lead = self._flatten(tree_)
        plan = self._plan(leaves)
        reqs: Dict[Any, Any] = {}
        for i in plan.big:
            reqs[("big", i)] = self.comm.iallreduce(leaves[i])
        for k, bucket in enumerate(plan.buckets):
            flat = torch.cat([leaves[i].reshape(lead, -1) for i in bucket],
                             dim=1)
            reqs[("bucket", k)] = self.comm.iallreduce(flat)
        _passes.add()
        return PendingTreePass(self, "allreduce", treedef, plan, reqs,
                               lead)

    def issue_reduce_scatter(self, tree_) -> PendingTreePass:
        """Overlapped tree REDUCE_SCATTER: each leaf's row is padded to
        ``n`` chunks and packed rank-major, one ``ireduce_scatter_block``
        per bucket; ``wait()`` returns the per-leaf shard tree (leaf i ->
        (lead, ceil(row/n)))."""
        n = self.comm.size
        treedef, leaves, lead = self._flatten(tree_)

        def rows(l: torch.Tensor) -> torch.Tensor:
            flat = l.reshape(lead, -1)
            pad = (-flat.shape[1]) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros((lead, pad))], dim=1)
            return flat.reshape(lead, n, -1)

        plan = self._plan(leaves)
        reqs: Dict[Any, Any] = {}
        for i in plan.big:
            reqs[("big", i)] = self.comm.ireduce_scatter_block(
                rows(leaves[i]).reshape(lead, -1))
        for k, bucket in enumerate(plan.buckets):
            packed = torch.cat([rows(leaves[i]) for i in bucket], dim=2)
            reqs[("bucket", k)] = self.comm.ireduce_scatter_block(
                packed.reshape(lead, -1))
        _passes.add()
        return PendingTreePass(self, "reduce_scatter", treedef, plan,
                               reqs, lead)

    def issue_allgather(self, shards, shapes) -> PendingTreePass:
        """Overlapped tree ALLGATHER of flat shards back to full leaves:
        one ``iallgather`` per bucket; ``wait()`` returns leaves of shape
        ``(lead,) + shapes[leaf]``."""
        treedef, leaves, lead = self._flatten(shards)
        shape_list = _shape_leaves(shapes, len(leaves))
        plan = self._plan(leaves)
        reqs: Dict[Any, Any] = {}
        for i in plan.big:
            reqs[("big", i)] = self.comm.iallgather(
                leaves[i].reshape(lead, -1))
        for k, bucket in enumerate(plan.buckets):
            packed = torch.cat([leaves[i].reshape(lead, -1)
                                for i in bucket], dim=1)
            reqs[("bucket", k)] = self.comm.iallgather(packed)
        _passes.add()
        return PendingTreePass(self, "allgather", treedef, plan, reqs,
                               lead, shapes=shape_list)
