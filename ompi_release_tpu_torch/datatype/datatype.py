"""MPI-style datatypes over torch tensors (counterpart of
``ompi_release_tpu/datatype/datatype.py``).

The reference describes a type as a list of (primitive, offset) pairs
walked by byte-oriented pack/unpack state machines
(``opal/datatype/opal_convertor.c``; constructors
``ompi/datatype/ompi_datatype_create_*.c``). Here, as in the JAX
package, every derived type flattens to an **element index map**: an
int32 numpy array of element offsets into the origin buffer, kept on
the host, so pack is one ``index_select`` and unpack one indexed store
on the device. The map's device copy is made once per device and cached
on the type (:meth:`Datatype.device_offsets`).

The named types are torch dtypes: ``BFLOAT16`` is ``torch.bfloat16``
(no fallback) and ``DOUBLE`` is ``torch.float64``, 8 bytes on the wire.

Supported constructors: contiguous, vector/hvector, indexed/hindexed,
indexed_block, struct (homogeneous dtype), subarray and darray; dup and
resized (extent override).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Datatype:
    """An MPI datatype: an element dtype + an index map over elements.

    ``index_map`` is None for predefined/contiguous-from-zero types
    (identity map of length ``count``); otherwise an int32 array of
    element offsets (in units of ``base_dtype`` elements, not bytes).

    ``extent`` is in elements: how far successive items of this type
    advance in the origin buffer (MPI_Type_get_extent; resized types
    give strided sends).
    """

    name: str
    base_dtype: torch.dtype  # element dtype (what the wire carries)
    count: int  # number of base elements per item (MPI size analogue)
    index_map: Optional[np.ndarray] = None
    extent: Optional[int] = None  # in elements; defaults to span
    committed: bool = True
    #: (n_items, device) -> the offsets as a device tensor; not part of
    #: the type's identity, shared by ``dup`` (same map)
    _device_cache: Dict[Tuple[int, str], torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.index_map is not None:
            object.__setattr__(
                self, "index_map", np.asarray(self.index_map, dtype=np.int32)
            )
            assert self.index_map.ndim == 1
            assert len(self.index_map) == self.count

    # -- queries ----------------------------------------------------------
    @property
    def size_bytes(self) -> int:
        """Bytes of actual data per item (MPI_Type_size)."""
        return self.count * self.base_dtype.itemsize

    @property
    def span(self) -> int:
        """Elements from first to one-past-last touched offset."""
        if self.index_map is None:
            return self.count
        if len(self.index_map) == 0:
            return 0
        return int(self.index_map.max()) + 1

    @property
    def true_extent(self) -> int:
        return self.span

    def get_extent(self) -> int:
        return self.extent if self.extent is not None else self.span

    @property
    def is_contiguous(self) -> bool:
        if self.index_map is None:
            return True
        return bool(
            np.array_equal(self.index_map, np.arange(self.count, dtype=np.int32))
        )

    # -- offsets ----------------------------------------------------------
    def offsets(self, n_items: int = 1) -> np.ndarray:
        """Element offsets for ``n_items`` consecutive items."""
        base = (
            np.arange(self.count, dtype=np.int32)
            if self.index_map is None
            else self.index_map
        )
        if n_items == 1:
            return base
        ext = self.get_extent()
        starts = (np.arange(n_items, dtype=np.int32) * ext)[:, None]
        return (starts + base[None, :]).reshape(-1)

    def device_offsets(self, n_items: int, device) -> torch.Tensor:
        """:meth:`offsets` as an int32 tensor on ``device``, copied over
        once and cached (the gather's index)."""
        key = (n_items, str(torch.device(device)))
        t = self._device_cache.get(key)
        if t is None:
            t = torch.from_numpy(self.offsets(n_items)).to(device)
            self._device_cache[key] = t
        return t

    # -- constructors (MPI_Type_* analogues) -------------------------------
    def dup(self, name: Optional[str] = None) -> "Datatype":
        return dataclasses.replace(self, name=name or f"dup({self.name})")

    def resized(self, extent: int) -> "Datatype":
        """MPI_Type_create_resized: override the extent."""
        return dataclasses.replace(
            self, extent=extent, name=f"resized({self.name},{extent})",
            _device_cache={},
        )

    def __repr__(self) -> str:  # keep test output readable
        return (
            f"Datatype({self.name}, {self.base_dtype}, count={self.count}, "
            f"extent={self.get_extent()}, contig={self.is_contiguous})"
        )


def _predef(name: str, dtype: torch.dtype) -> Datatype:
    return Datatype(name=name, base_dtype=dtype, count=1)


FLOAT = _predef("float", torch.float32)
DOUBLE = _predef("double", torch.float64)  # 8 bytes on the wire
BFLOAT16 = _predef("bfloat16", torch.bfloat16)
INT8 = _predef("int8", torch.int8)
INT16 = _predef("int16", torch.int16)
INT32 = _predef("int32", torch.int32)
INT64 = _predef("int64", torch.int64)
UINT8 = _predef("uint8", torch.uint8)
UINT16 = _predef("uint16", torch.uint16)
UINT32 = _predef("uint32", torch.uint32)
UINT64 = _predef("uint64", torch.uint64)
BYTE = _predef("byte", torch.uint8)
BOOL = _predef("bool", torch.bool)
COMPLEX64 = _predef("complex64", torch.complex64)

PREDEFINED = {
    t.name: t
    for t in [
        FLOAT, DOUBLE, BFLOAT16, INT8, INT16, INT32, INT64, UINT8, UINT16,
        UINT32, UINT64, BYTE, BOOL, COMPLEX64,
    ]
}


def from_torch_dtype(dtype) -> Datatype:
    """Map a torch (or numpy) dtype to the matching predefined
    Datatype."""
    if not isinstance(dtype, torch.dtype):
        if str(dtype) == "bfloat16":
            return BFLOAT16
        dtype = torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype
    for t in PREDEFINED.values():
        if t.base_dtype == dtype:
            return t
    raise ValueError(f"no predefined datatype for {dtype!r}")


def create_contiguous(count: int, base: Datatype) -> Datatype:
    """MPI_Type_contiguous (``ompi_datatype_create_contiguous.c``)."""
    offs = base.offsets(count)
    contiguous = bool(
        np.array_equal(offs, np.arange(len(offs), dtype=np.int32))
    )
    return Datatype(
        name=f"contig({count},{base.name})",
        base_dtype=base.base_dtype,
        count=base.count * count,
        index_map=None if contiguous else offs,
        extent=base.get_extent() * count,
    )


def create_vector(count: int, blocklength: int, stride: int,
                  base: Datatype) -> Datatype:
    """MPI_Type_vector: ``count`` blocks of ``blocklength`` items, start
    offsets ``stride`` items apart (``ompi_datatype_create_vector.c``)."""
    ext = base.get_extent()
    block = base.offsets(blocklength)  # offsets within one block
    starts = (np.arange(count, dtype=np.int32) * stride * ext)[:, None]
    offs = (starts + block[None, :]).reshape(-1)
    return Datatype(
        name=f"vector({count},{blocklength},{stride},{base.name})",
        base_dtype=base.base_dtype,
        count=len(offs),
        index_map=offs,
        extent=((count - 1) * stride + blocklength) * ext if count else 0,
    )


def create_hindexed(blocklengths: Sequence[int], displacements: Sequence[int],
                    base: Datatype) -> Datatype:
    """MPI_Type_create_hindexed (displacements in elements, not bytes)."""
    assert len(blocklengths) == len(displacements)
    parts: List[np.ndarray] = []
    for bl, disp in zip(blocklengths, displacements):
        parts.append(disp + base.offsets(bl))
    offs = (
        np.concatenate(parts).astype(np.int32)
        if parts
        else np.zeros(0, np.int32)
    )
    return Datatype(
        name=f"hindexed({list(blocklengths)},{list(displacements)},{base.name})",
        base_dtype=base.base_dtype,
        count=len(offs),
        index_map=offs,
    )


def create_indexed_block(blocklength: int, displacements: Sequence[int],
                         base: Datatype) -> Datatype:
    return create_hindexed(
        [blocklength] * len(displacements), displacements, base
    )


def create_struct(blocklengths: Sequence[int], displacements: Sequence[int],
                  types: Sequence[Datatype]) -> Datatype:
    """MPI_Type_create_struct, homogeneous element dtype: a tensor has
    one dtype, so struct members must share it (a heterogeneous struct
    is split into one message per dtype above this layer)."""
    if not (len(blocklengths) == len(displacements) == len(types)):
        raise ValueError(
            f"struct argument lengths differ: {len(blocklengths)} "
            f"blocklengths, {len(displacements)} displacements, "
            f"{len(types)} types"
        )
    dtypes = {t.base_dtype for t in types}
    if len(dtypes) != 1:
        raise ValueError(
            "struct datatypes must be homogeneous; split per-dtype "
            f"(got {sorted(str(d) for d in dtypes)})"
        )
    parts = []
    for bl, disp, t in zip(blocklengths, displacements, types):
        for i in range(bl):
            parts.append(disp + i * t.get_extent() + t.offsets(1))
    offs = (
        np.concatenate(parts).astype(np.int32)
        if parts
        else np.zeros(0, np.int32)
    )
    return Datatype(
        name="struct",
        base_dtype=types[0].base_dtype,
        count=len(offs),
        index_map=offs,
    )


def _sorted_offsets(per_dim: Sequence[np.ndarray],
                    dims: Sequence[int]) -> np.ndarray:
    """C-order flat offsets of the cross product of per-dimension
    index lists, ascending (sorting is skipped when the row-major
    product already is)."""
    grids = np.meshgrid(*per_dim, indexing="ij")
    flat = np.ravel_multi_index([g.reshape(-1) for g in grids], dims=dims)
    if flat.size > 1 and not bool(np.all(flat[1:] >= flat[:-1])):
        flat = np.sort(flat)
    return flat.astype(np.int32)


def create_subarray(sizes: Sequence[int], subsizes: Sequence[int],
                    starts: Sequence[int], base: Datatype) -> Datatype:
    """MPI_Type_create_subarray (C order), the MPI-IO workhorse."""
    assert len(sizes) == len(subsizes) == len(starts)
    offs = _sorted_offsets(
        [np.arange(st, st + ss) for st, ss in zip(starts, subsizes)], sizes)
    if base.count != 1:
        offs = (offs[:, None] * base.get_extent() + base.offsets(1)[None, :]).reshape(-1)
    return Datatype(
        name=f"subarray({list(sizes)},{list(subsizes)},{list(starts)})",
        base_dtype=base.base_dtype,
        count=len(offs),
        index_map=offs,
        extent=int(np.prod(sizes)) * base.get_extent(),
    )


# MPI_Type_create_darray distribution constants
DIST_BLOCK = "block"
DIST_CYCLIC = "cyclic"
DIST_NONE = "none"
DARG_DEFAULT = -1  # MPI_DISTRIBUTE_DFLT_DARG


def _dim_indices(gsize: int, dist: str, darg: int, nprocs: int,
                 coord: int) -> np.ndarray:
    """Global indices along one dim owned by process ``coord``."""
    if dist == DIST_NONE:
        if nprocs != 1:
            raise ValueError(
                "DIST_NONE requires 1 process on that dimension"
            )
        return np.arange(gsize)
    if dist == DIST_BLOCK:
        # MPI: default block size = ceil(gsize / nprocs); an explicit
        # darg must cover the array (darg * nprocs >= gsize)
        bsize = -(-gsize // nprocs) if darg == DARG_DEFAULT else darg
        if bsize * nprocs < gsize:
            raise ValueError(
                f"block darg {bsize} too small: {bsize}*{nprocs} < "
                f"{gsize}"
            )
        lo = coord * bsize
        return np.arange(lo, min(lo + bsize, gsize))
    if dist == DIST_CYCLIC:
        bsize = 1 if darg == DARG_DEFAULT else darg
        if bsize < 1:
            # a non-positive block size would select nothing: an MPI-IO
            # write with that type would lose data silently
            raise ValueError(
                f"cyclic darg must be >= 1, got {bsize}"
            )
        idx = []
        start = coord * bsize
        stride = nprocs * bsize
        for base_i in range(start, gsize, stride):
            idx.extend(range(base_i, min(base_i + bsize, gsize)))
        return np.asarray(idx, dtype=np.int64)
    raise ValueError(f"unknown distribution '{dist}'")


def create_darray(size: int, rank: int, gsizes: Sequence[int],
                  distribs: Sequence[str], dargs: Sequence[int],
                  psizes: Sequence[int], base: Datatype) -> Datatype:
    """MPI_Type_create_darray (C order): the datatype selecting rank's
    portion of a block/cyclic-distributed global array — the HPF-style
    decomposition MPI-IO uses for parallel array files
    (``ompi/datatype/ompi_datatype_create_darray.c`` role).

    ``size``/``rank``: process grid population and this process's
    rank (row-major over ``psizes``). Each dim: distribution
    ``block``/``cyclic``/``none`` with ``dargs[i]`` (DARG_DEFAULT for
    the MPI default block size).
    """
    ndims = len(gsizes)
    if not (len(distribs) == len(dargs) == len(psizes) == ndims):
        raise ValueError("darray argument lengths differ")
    if int(np.prod(psizes)) != size:
        raise ValueError(
            f"process grid {list(psizes)} does not cover {size} procs"
        )
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside process grid of {size}")
    # rank -> process-grid coordinates, row-major (MPI order)
    coords = []
    r = rank
    for p in reversed(psizes):
        coords.append(r % p)
        r //= p
    coords = list(reversed(coords))

    per_dim = [
        _dim_indices(g, d, a, p, c)
        for g, d, a, p, c in zip(gsizes, distribs, dargs, psizes, coords)
    ]
    offs = _sorted_offsets(per_dim, gsizes)
    if base.count != 1:
        offs = (offs[:, None] * base.get_extent()
                + base.offsets(1)[None, :]).reshape(-1)
    return Datatype(
        name=f"darray(r{rank}/{size},{list(gsizes)})",
        base_dtype=base.base_dtype,
        count=len(offs),
        index_map=offs,
        extent=int(np.prod(gsizes)) * base.get_extent(),
    )
