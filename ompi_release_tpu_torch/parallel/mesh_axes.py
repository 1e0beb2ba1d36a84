"""Canonical mesh-axis conventions and the stacked-rank mesh.

Counterpart of ``ompi_release_tpu/parallel/mesh_axes.py``: the five axis
names, outermost to innermost, and ``build_parallel_mesh``. A JAX mesh
places one device at each coordinate and runs the per-rank body under
``shard_map``; here every rank of the mesh is a *virtual rank* on one
device, and a per-rank value is ONE tensor whose leading dims are the
mesh's axes in order (``CANONICAL_ORDER`` for a ``build_parallel_mesh``
mesh), followed by the rank's own dims:

- a leading dim of the axis's size holds one slice per rank (the value
  varies over that axis); a leading dim of size 1 is shared by every
  rank of the axis (the value is invariant over it, as JAX's
  replication tracking would type it). A tensor with no leading dims at
  all (a constant made inside the body) is invariant over every axis
  and broadcasts as torch broadcasts;
- every per-rank op runs batched over the leading dims, one launch for
  all ranks; the axis collectives (``parallel/axes.py``) fold, gather
  or transpose along them.

Entering a mesh (``with mesh:``) binds its axes as the axis environment
the per-rank functions of ``parallel/`` read, the role of shard_map's
axis names; the port's ``vary_like``/``vary_over`` have no counterpart:
varying or invariant is the size of a leading dim, so there is no type
to cast. ``stack`` / ``unstack`` are ``in_specs`` / ``out_specs``: the
stacked views of a global tensor under a ``PartitionSpec`` and back.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXIS_DP = "dp"  # data parallel (gradient psum)
AXIS_PP = "pp"  # pipeline stages (ppermute ring)
AXIS_SP = "sp"  # sequence/context parallel (alltoall / K-V ring)
AXIS_EP = "ep"  # expert parallel (token-routing all-to-all)
AXIS_TP = "tp"  # tensor parallel (psum/all_gather, innermost)

#: outermost -> innermost
CANONICAL_ORDER = (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_EP, AXIS_TP)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim, each None
    (not sharded), an axis name, or a tuple of axis names (the dim split
    over them, the first outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec

_bound = threading.local()


def current_mesh() -> Optional["ParallelMesh"]:
    """The mesh whose axes are bound on this thread (``with mesh:``), or
    None outside every mesh."""
    stack = getattr(_bound, "stack", None)
    return stack[-1] if stack else None


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelMesh:
    """Axis sizes (name -> size, outermost first) and the one device all
    ``size`` virtual ranks live on."""

    shape: Dict[str, int]
    device: torch.device

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def lead(self) -> int:
        """How many leading (rank) dims a stacked value has."""
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_dim(self, name: str) -> int:
        """The leading dim of axis ``name``."""
        try:
            return self.names.index(name)
        except ValueError:
            raise NameError(f"unbound axis name: {name}") from None

    def axis_size_or_1(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name: str, ndim: int = 0) -> torch.Tensor:
        """``lax.axis_index(name)`` as an int64 tensor: the rank's index
        along the axis at its leading dim, size 1 at every other, and
        ``ndim`` trailing size-1 dims (to broadcast against per-rank
        values of ``ndim`` dims)."""
        shape = [1] * self.lead + [1] * ndim
        shape[self.axis_dim(name)] = self.shape[name]
        return torch.arange(self.shape[name],
                            device=self.device).view(shape)

    def __enter__(self) -> "ParallelMesh":
        stack = getattr(_bound, "stack", None)
        if stack is None:
            stack = _bound.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _bound.stack.pop()

    # -- in_specs / out_specs -------------------------------------------

    def stack(self, x: torch.Tensor, spec=()) -> torch.Tensor:
        """The stacked per-rank views of the global ``x`` under ``spec``:
        a dim sharded over axes splits (outermost axis first) and each
        axis's part moves to its leading dim; an axis the spec does not
        name gets a size-1 leading dim (every rank shares the data). A
        view of ``x`` wherever ``x`` is contiguous: no copy."""
        spec = tuple(spec) + (None,) * (x.dim() - len(spec))
        if len(spec) != x.dim():
            raise ValueError(f"spec {spec} has more entries than the "
                             f"{x.dim()}-d tensor has dims")
        shape: List[int] = []
        pos: Dict[str, int] = {}
        local: List[int] = []
        for d, entry in enumerate(spec):
            names = _spec_axes(entry)
            k = math.prod(self.shape[n] for n in names)
            if x.shape[d] % k:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not "
                                 f"split over {names} ({k} ranks)")
            for n in names:
                if n in pos:
                    raise ValueError(f"axis {n} used twice in {spec}")
                pos[n] = len(shape)
                shape.append(self.shape[n])
            local.append(len(shape))
            shape.append(x.shape[d] // k)
        missing = [n for n in self.names if n not in pos]
        for n in missing:
            pos[n] = len(shape)
            shape.append(1)
        y = x.reshape(shape)
        return y.permute([pos[n] for n in self.names] + local)

    def unstack(self, x: torch.Tensor, spec=()) -> torch.Tensor:
        """The global tensor the stacked ``x`` holds under ``spec`` (the
        inverse of :meth:`stack`): sharded dims are reassembled, and an
        axis the spec does not name must be one the value is invariant
        over (its rank 0 slice is taken)."""
        k = x.dim() - self.lead
        spec = tuple(spec) + (None,) * (k - len(spec))
        named = {n for e in spec for n in _spec_axes(e)}
        y = x
        for i, n in enumerate(self.names):
            if n not in named and y.shape[i] != 1:
                y = y.narrow(i, 0, 1)
        full = [self.shape[n] if n in named else 1 for n in self.names]
        y = y.expand(full + list(y.shape[self.lead:]))
        order: List[int] = []
        out_shape: List[int] = []
        for d, entry in enumerate(spec):
            names = _spec_axes(entry)
            order.extend(self.axis_dim(n) for n in names)
            order.append(self.lead + d)
            out_shape.append(math.prod(self.shape[n] for n in names)
                             * y.shape[self.lead + d])
        rest = [i for i, n in enumerate(self.names) if n not in named]
        return y.permute(order + rest).reshape(out_shape)


def build_parallel_mesh(dp: int = 1, pp: int = 1, sp: int = 1, ep: int = 1,
                        tp: int = 1,
                        devices: Optional[Sequence] = None) -> ParallelMesh:
    """Mesh with all five canonical axes (size-1 axes kept so specs are
    uniform regardless of which strategies are active). All
    dp*pp*sp*ep*tp ranks are virtual ranks on one device: ``cuda:0``
    unless ``devices`` names it (``[torch.device("cpu")]`` for the
    tests). ``devices`` holds that one device, or one entry per rank,
    all the same device."""
    sizes = (dp, pp, sp, ep, tp)
    for name, n in zip(CANONICAL_ORDER, sizes):
        if not isinstance(n, int) or n < 1:
            raise ValueError(f"axis {name} size {n!r}: a positive int")
    n = math.prod(sizes)
    if devices is None:
        from ..runtime.ess import discover_devices

        devices = discover_devices()[:1]
    devs = {torch.device(d) for d in devices}
    if len(devices) not in (1, n) or len(devs) != 1:
        raise ValueError(
            f"dp*pp*sp*ep*tp = {n} but {len(devices)} devices given: the "
            "ranks are virtual ranks of one device (pass it once, or once "
            "per rank)")
    return ParallelMesh(shape=dict(zip(CANONICAL_ORDER, sizes)),
                        device=devs.pop())


def axis_size_or_1(axis_name: str) -> int:
    """The bound mesh's size for ``axis_name``; 1 when no mesh is bound
    or it has no such axis (so layer code runs with any subset of axes
    bound, and outside every mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.axis_size_or_1(axis_name)
