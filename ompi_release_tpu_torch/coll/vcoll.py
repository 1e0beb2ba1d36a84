"""v-variant collectives: per-rank counts over equal-block kernels
(counterpart of ``ompi_release_tpu/coll/vcoll.py``).

The reference implements MPI_Alltoallv/Allgatherv/Gatherv/Scatterv and
general MPI_Reduce_scatter as count/displacement-driven send/recv loops
(``ompi/mca/coll/tuned/coll_tuned_alltoallv.c``, ``coll_base`` linear
variants). As in the JAX package, each v-collective splits in two:

  host edge (here)            ragged per-rank buffers <-> one padded
                              rectangular tensor (pad to the max count;
                              the op identity as filler)
  kernel (coll/spmd.py)       the equal-block collective on the padded
                              tensor, cached per (kernel, n, cap, dtype)
                              — counts are not part of the key

The JAX package stages the padded array through host numpy, one slice
per (i, j). Here the counts stay on the host but the payload never
leaves the comm's device: padding is ONE gather through an index built
on the device from the (n, n) count table (the datatype engine's idea),
and so is the unpadding. The results are the same bits.

Driver-mode conventions (``comm/communicator.py``): rank-dependent
inputs and outputs are Python lists indexed by rank (ragged lengths
make a leading-axis tensor impossible); results identical on every rank
are returned once. Buffers are torch tensors or numpy arrays; results
are tensors on the comm's device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..mca import pvar as _pvar
from ..mca import var as mca_var
from ..ops.op import Op
from ..utils.errors import ErrorCode, MPIError
from . import spmd
from .driver import as_rank_buffer, run_sharded

_padded_elems = _pvar.counter(
    "vcoll_alltoallv_padded_elems",
    "elements moved by the padded alltoallv kernel",
)
_overflow_elems = _pvar.counter(
    "vcoll_alltoallv_overflow_elems",
    "hot-pair tail elements delivered outside the padded kernel "
    "(skew mitigation)",
)


def _as_1d_tensors(comm, bufs, what: str) -> List[torch.Tensor]:
    n = comm.size
    if len(bufs) != n:
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"{what} needs one buffer per rank ({n}), got {len(bufs)}",
        )
    out = [as_rank_buffer(b, comm.device).reshape(-1) for b in bufs]
    dtypes = {t.dtype for t in out}
    if len(dtypes) != 1:
        raise MPIError(
            ErrorCode.ERR_TYPE,
            f"{what} buffers must share one dtype, got "
            f"{sorted(map(str, dtypes))}",
        )
    return out


def _counts_matrix(counts, n: int) -> np.ndarray:
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    c = np.asarray(counts, dtype=np.int64)
    if c.shape != (n, n) or (c < 0).any():
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"need a non-negative ({n},{n}) count matrix, got {c.shape}",
        )
    return c


def _segments(starts: np.ndarray, lengths: np.ndarray,
              device: torch.device) -> torch.Tensor:
    """The int64 index of the concatenated ranges ``[starts[s],
    starts[s] + lengths[s])`` in segment order, built on ``device``
    from the two small host tables: output slot p belongs to the last
    segment whose first slot is <= p (a binary search per slot; the
    segments are few, the slots many)."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    total = int(lengths.sum())
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    keep = lengths > 0
    starts, lengths = starts[keep], lengths[keep]
    first = np.cumsum(lengths) - lengths  # each segment's first slot
    table = torch.from_numpy(np.stack([first, starts - first])).to(device)
    slots = torch.arange(total, dtype=torch.int64, device=device)
    seg = torch.searchsorted(table[0], slots, right=True) - 1
    return slots + table[1][seg]


def _pad_index(starts: np.ndarray, lengths: np.ndarray, cap: int,
               sentinel: int, device: torch.device) -> torch.Tensor:
    """Index of a padded (..., cap) layout: slot t of row s reads
    ``starts[s] + t`` while t < lengths[s], else ``sentinel`` (the
    filler element appended to the source)."""
    shape = starts.shape
    st = torch.from_numpy(np.array(starts, np.int64)).to(device)
    ln = torch.from_numpy(np.array(lengths, np.int64)).to(device)
    t = torch.arange(cap, dtype=torch.int64, device=device)
    idx = torch.where(t < ln[..., None], st[..., None] + t,
                      torch.full((), sentinel, dtype=torch.int64,
                                 device=device))
    return idx.reshape(tuple(shape) + (cap,))


def _padded(flat: torch.Tensor, starts: np.ndarray, lengths: np.ndarray,
            cap: int, fill) -> torch.Tensor:
    """``flat`` regrouped into a padded (..., cap) tensor, ``fill`` in
    the tails: one gather on the device."""
    src = torch.cat([flat, torch.full((1,), fill, dtype=flat.dtype,
                                      device=flat.device)])
    idx = _pad_index(starts, lengths, cap, flat.numel(), flat.device)
    return src[idx]


def _split(flat: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    return list(torch.split(flat, [int(k) for k in sizes]))


# ---------------------------------------------------------------------------
# alltoallv
# ---------------------------------------------------------------------------

def _skew_cap(c: np.ndarray) -> int:
    """Padding cap for a skewed count matrix.

    The padded kernel moves n·n·cap elements whatever the counts, so ONE
    hot (rank, rank) pair makes every pair pay its count. When the max
    exceeds ``coll_alltoallv_skew_factor`` × the median nonzero count,
    the pad is capped at the 90th-percentile count and the hot pairs'
    tails bypass the kernel (:func:`alltoallv`)."""
    nz = c[c > 0]
    if nz.size <= 1:
        return int(c.max()) if c.size else 1
    cmax = int(nz.max())
    factor = int(mca_var.get("coll_alltoallv_skew_factor", 4))
    med = max(1, int(np.median(nz)))
    if factor > 0 and cmax > factor * med:
        return max(1, int(np.quantile(nz, 0.9)))
    return cmax


def alltoallv(comm, sendbufs: Sequence, sendcounts, *,
              kernel: str = "lax") -> List[torch.Tensor]:
    """Every rank sends ``sendcounts[i][j]`` elements to rank j.

    ``sendbufs[i]`` = rank i's send buffer: its chunks for ranks 0..n-1
    back to back (MPI's sdispls implicit). Returns ``recv[i]`` = the
    chunks from ranks 0..n-1 in source order, MPI_Alltoallv's receive
    layout. Skewed count matrices are capped (:func:`_skew_cap`): the
    hot pairs' tails are read straight from the send buffers into the
    receive buffers (``vcoll_alltoallv_overflow_elems``)."""
    n = comm.size
    bufs = _as_1d_tensors(comm, sendbufs, "alltoallv")
    c = _counts_matrix(sendcounts, n)
    for i in range(n):
        if bufs[i].shape[0] != int(c[i].sum()):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"alltoallv rank {i}: buffer has {bufs[i].shape[0]} "
                f"elements, counts sum to {int(c[i].sum())}",
            )
    cap = _skew_cap(c)
    dtype = bufs[0].dtype
    base_c = np.minimum(c, cap)
    send = torch.cat(bufs) if n > 1 else bufs[0]
    # start of chunk (i, j) in the concatenated send buffer
    starts = (np.cumsum(c.reshape(-1)) - c.reshape(-1)).reshape(n, n)
    padded = _padded(send, starts, base_c, cap, 0)  # (n, n, cap)
    body = (spmd.alltoall_lax if kernel == "lax"
            else spmd.alltoall_pairwise)
    out = run_sharded(comm, (kernel, "alltoallv", n, cap, dtype),
                      lambda xb: body(xb, n), padded)
    _padded_elems.add(n * n * cap)
    overflow = int((c - base_c).sum())
    _overflow_elems.add(overflow)
    # receive layout: for rank i, per source j, the kernel's slot
    # out[i, j] (base_c[j, i] elements), then the overflow tail of pair
    # (j, i) straight from the send buffer
    src = torch.cat([out.reshape(-1), send])
    i_idx, j_idx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    seg_start = np.stack([(i_idx * n + j_idx) * cap,
                          out.numel() + starts.T + base_c.T], axis=-1)
    seg_len = np.stack([base_c.T, (c - base_c).T], axis=-1)
    recv = src[_segments(seg_start, seg_len, comm.device)]
    return _split(recv, c.sum(axis=0)) if n > 1 else [recv]


# ---------------------------------------------------------------------------
# allgatherv / gatherv
# ---------------------------------------------------------------------------

def allgatherv(comm, sendbufs: Sequence, *, kernel: str = "lax"):
    """Concatenate every rank's (ragged) buffer in rank order; the
    result is identical on all ranks, returned once."""
    n = comm.size
    bufs = _as_1d_tensors(comm, sendbufs, "allgatherv")
    counts = np.asarray([b.shape[0] for b in bufs], np.int64)
    cmax = max(1, int(counts.max()))
    dtype = bufs[0].dtype
    starts = np.cumsum(counts) - counts
    padded = _padded(torch.cat(bufs), starts, counts, cmax, 0)  # (n, cmax)
    if kernel == "ring":
        body = lambda xb: spmd.allgather_ring(xb, n)  # noqa: E731
    else:
        body = spmd.allgather_lax
    out = run_sharded(comm, (kernel, "allgatherv", n, cmax, dtype), body,
                      padded)
    # (n, n, cmax): every row the same gathered copy; read rank 0's
    g = out[0].reshape(-1)
    return g[_segments(np.arange(n) * cmax, counts, comm.device)]


def gatherv(comm, sendbufs: Sequence, root: int, *, kernel: str = "lax"):
    """Root receives the rank-order concatenation (other ranks' recv
    buffers are undefined in MPI).

    The reference's gatherv is linear: non-root ranks send exactly
    their own buffer and only root receives. The rank-axis analogue of
    "root receives rank i's message" is reading each rank's buffer
    where it already lies, so this is a concatenation after a completion
    barrier: no padded collective, no per-rank O(total) receive buffer.
    ``kernel`` is accepted for symmetry with :func:`allgatherv`."""
    n = comm.size
    if not 0 <= root < n:
        raise MPIError(ErrorCode.ERR_ROOT, f"bad root {root}")
    bufs = _as_1d_tensors(comm, sendbufs, "gatherv")
    comm.barrier()
    return torch.cat(bufs)


# ---------------------------------------------------------------------------
# scatterv
# ---------------------------------------------------------------------------

def scatterv(comm, sendbuf, counts: Sequence[int],
             root: int) -> List[torch.Tensor]:
    """Root's buffer split into ``counts[i]`` elements for rank i."""
    n = comm.size
    if not 0 <= root < n:
        raise MPIError(ErrorCode.ERR_ROOT, f"bad root {root}")
    counts = [int(k) for k in counts]
    if len(counts) != n or any(k < 0 for k in counts):
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"scatterv needs {n} non-negative counts, got {counts}",
        )
    buf = as_rank_buffer(sendbuf, comm.device).reshape(-1)
    if buf.shape[0] != sum(counts):
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"scatterv root buffer has {buf.shape[0]} elements, counts "
            f"sum to {sum(counts)}",
        )
    cnt = np.asarray(counts, np.int64)
    cmax = max(1, int(cnt.max()) if n else 1)
    dtype = buf.dtype
    # only root's row carries data (bcast-masked in the kernel)
    starts = np.zeros((n, n), np.int64)
    lengths = np.zeros((n, n), np.int64)
    starts[root] = np.cumsum(cnt) - cnt
    lengths[root] = cnt
    padded = _padded(buf, starts, lengths, cmax, 0)  # (n, n, cmax)

    def body(xb):
        full = spmd.bcast_masked_psum(xb, root)
        return spmd._take(full, list(range(n)))

    out = run_sharded(comm, ("fused", "scatterv", n, cmax, dtype, root),
                      body, padded)
    return _split(out.reshape(-1)[_segments(np.arange(n) * cmax, cnt,
                                            comm.device)], counts)


# ---------------------------------------------------------------------------
# reduce_scatter (general, per-rank counts)
# ---------------------------------------------------------------------------

def reduce_scatter(comm, x, recvcounts: Sequence[int], op: Op, *,
                   kernel: str = "lax") -> List:
    """General MPI_Reduce_scatter: reduce the full buffer, rank i keeps
    the segment of length ``recvcounts[i]``.

    ``x``: (size, total) per-rank contribution rows, total =
    sum(recvcounts). Returns one tensor per rank. MINLOC/MAXLOC pairs
    are accepted: ``x = (values, indices)`` and each returned segment
    is a (values, indices) pair."""
    n = comm.size
    recvcounts = [int(k) for k in recvcounts]
    if len(recvcounts) != n or any(k < 0 for k in recvcounts):
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"reduce_scatter needs {n} non-negative counts",
        )
    total = sum(recvcounts)
    if op.is_pair_op:
        vals, idxs = (as_rank_buffer(a, comm.device) for a in x)
        for nm, a in (("values", vals), ("indices", idxs)):
            if a.shape[0] != n or a.reshape(n, -1).shape[1] != total:
                raise MPIError(
                    ErrorCode.ERR_COUNT,
                    f"reduce_scatter needs {nm} shaped ({n}, {total}), "
                    f"got {tuple(a.shape)}",
                )
        # the pair allreduce does the reduction; the segments are
        # sliced from its result
        rv, ri = comm.allreduce((vals.reshape(n, total),
                                 idxs.reshape(n, total)), op)
        return list(zip(_split(rv[0], recvcounts),
                        _split(ri[0], recvcounts)))
    x = as_rank_buffer(x, comm.device)
    if x.shape[0] != n or x.reshape(n, -1).shape[1] != total:
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"reduce_scatter needs x shaped (size, {total}), got "
            f"{tuple(x.shape)}",
        )
    x = x.reshape(n, total)
    cnt = np.asarray(recvcounts, np.int64)
    cmax = max(1, int(cnt.max()) if n else 1)
    dtype = x.dtype
    ident = op.identity_for(dtype) if op.identity is not None else 0
    seg = np.cumsum(cnt) - cnt
    starts = np.arange(n)[:, None] * total + seg[None, :]
    padded = _padded(x.reshape(-1), starts, np.broadcast_to(cnt, (n, n)),
                     cmax, ident)  # (n, n, cmax)
    if kernel == "ring" and op.commutative and op.identity is not None:
        def body(xb):
            return spmd.reduce_scatter_ring(xb.reshape(n, -1), op, n)
    else:
        def body(xb):
            return spmd.fold_ranks(xb, op).clone()

    out = run_sharded(comm, (kernel, "reduce_scatter", op, n, cmax, dtype),
                      body, padded)
    return _split(out.reshape(-1)[_segments(np.arange(n) * cmax, cnt,
                                            comm.device)], recvcounts)
