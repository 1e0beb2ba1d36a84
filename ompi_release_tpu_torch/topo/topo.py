"""Cartesian / graph / dist-graph topologies + neighborhood collectives.

Counterpart of ``ompi_release_tpu/topo/topo.py``. The reference's
``topo/basic`` component (``ompi/mca/topo``) provides rank<->coordinate
math and neighbor queries attached to a communicator; neighborhood
collectives live in coll. Here each neighbor slot's ``lax.ppermute``
over the rank axis is :func:`coll.spmd.ppermute`, an index gather along
dim 0 of the rank-stacked tensor; a missing neighbor (a non-periodic
edge, or a rank no edge reaches in a round) yields zeros, as
``ppermute`` gives them. The ragged (graph / dist-graph) schedules place
each round's received blocks with an index scatter into their slots,
the same bits as the reference's ``jnp.where`` one-hot placement. Every
neighborhood collective runs as one cached body through
:func:`coll.driver.run_sharded`; the ``ineighbor_*`` twins return a
Request completed by an event behind it (``coll/nbc.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coll import spmd
from ..coll.driver import run_sharded
from ..runtime.mesh import factorize_torus
from ..utils.errors import ErrorCode, MPIError


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """MPI_Dims_create: fill zero entries of ``dims`` with a balanced
    factorization."""
    if dims is None or not any(dims):
        return factorize_torus(nnodes, ndims)
    dims = list(dims)
    fixed = int(np.prod([d for d in dims if d > 0])) if any(
        d > 0 for d in dims
    ) else 1
    if nnodes % fixed:
        raise MPIError(
            ErrorCode.ERR_DIMS,
            f"cannot fill dims {dims} for {nnodes} nodes",
        )
    free = [i for i, d in enumerate(dims) if d <= 0]
    if not free:
        if fixed != nnodes:
            raise MPIError(
                ErrorCode.ERR_DIMS,
                f"fully-specified dims {dims} have product {fixed} != "
                f"{nnodes} nodes",
            )
        return tuple(dims)
    fills = factorize_torus(nnodes // fixed, len(free))
    for i, f in zip(free, fills):
        dims[i] = f
    return tuple(dims)


class _NonblockingNeighborsMixin:
    """ineighbor_* (libnbc's nbc_ineighbor_* analogue): the blocking
    body is enqueued on the device and wrapped in a Request, the same
    contract as ``comm.iallreduce``. Mixed into every topology class
    (each provides the blocking neighbor_* pair and a ``comm``)."""

    def ineighbor_allgather(self, x):
        return self.comm._async(self.neighbor_allgather(x))

    def ineighbor_alltoall(self, x):
        return self.comm._async(self.neighbor_alltoall(x))


class CartTopo(_NonblockingNeighborsMixin):
    """Cartesian topology attached to a communicator."""

    def __init__(self, comm, dims: Sequence[int],
                 periods: Sequence[bool]) -> None:
        self.comm = comm
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)
        if int(np.prod(self.dims)) != comm.size:
            raise MPIError(
                ErrorCode.ERR_DIMS,
                f"cart dims {self.dims} != comm size {comm.size}",
            )

    @property
    def ndims(self) -> int:
        return len(self.dims)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """MPI_Cart_coords (row-major, like the reference)."""
        c = []
        for d in reversed(self.dims):
            c.append(rank % d)
            rank //= d
        return tuple(reversed(c))

    def rank(self, coords: Sequence[int]) -> int:
        """MPI_Cart_rank; periodic dims wrap, others must be in range."""
        r = 0
        for d, p, c in zip(self.dims, self.periods, coords):
            if p:
                c %= d
            elif not 0 <= c < d:
                return -1  # MPI_PROC_NULL
            r = r * d + c
        return r

    def shift(self, dim: int, disp: int, rank: int) -> Tuple[int, int]:
        """MPI_Cart_shift -> (source, dest); -1 = MPI_PROC_NULL."""
        c = list(self.coords(rank))
        cd = list(c)
        cd[dim] += disp
        cs = list(c)
        cs[dim] -= disp
        return self.rank(cs), self.rank(cd)

    def _neighbor_at(self, rank: int, dim: int, delta: int) -> int:
        c = list(self.coords(rank))
        c[dim] += delta
        return self.rank(c)

    def neighbors(self, rank: int) -> List[int]:
        """Neighborhood order per MPI: for each dim, -1 then +1."""
        return [
            self._neighbor_at(rank, dim, delta)
            for dim in range(self.ndims)
            for delta in (-1, 1)
        ]

    def sub(self, remain_dims: Sequence[bool]):
        """MPI_Cart_sub: partition into sub-grids over the kept dims.
        Driver mode: returns the per-rank list of (subcomm, subtopo)."""
        keep = [i for i, k in enumerate(remain_dims) if k]
        drop = [i for i, k in enumerate(remain_dims) if not k]
        colors = []
        for r in range(self.comm.size):
            c = self.coords(r)
            color = 0
            for i in drop:
                color = color * self.dims[i] + c[i]
            colors.append(color)
        subs = self.comm.split(colors)
        sub_dims = tuple(self.dims[i] for i in keep)
        sub_periods = tuple(self.periods[i] for i in keep)
        out = []
        seen: Dict[int, CartTopo] = {}
        for sc in subs:
            if sc is None:
                out.append(None)
                continue
            if sc.cid not in seen:
                topo = CartTopo(sc, sub_dims, sub_periods)
                sc.topo = topo
                seen[sc.cid] = topo
            out.append((sc, seen[sc.cid]))
        return out

    # -- neighborhood collectives (one gather per neighbor slot) ----------
    def neighbor_perms(self) -> List[List[Tuple[int, int]]]:
        """One static (src, dst) edge list per neighbor slot, in the MPI
        neighbor order — each is one :func:`spmd.ppermute`."""
        perms: List[List[Tuple[int, int]]] = []
        for dim in range(self.ndims):
            for delta in (-1, 1):
                edges = []
                for r in range(self.comm.size):
                    nbr = self._neighbor_at(r, dim, delta)
                    if nbr >= 0:
                        edges.append((nbr, r))
                perms.append(edges)
        return perms

    def neighbor_allgather(self, x):
        """MPI_Neighbor_allgather, driver mode: x has a leading rank
        axis; returns (size, n_neighbors, ...) — slot order matches
        ``neighbors()``; missing neighbors (non-periodic edge) yield
        zeros."""
        perms = self.neighbor_perms()

        def body(xb):
            return torch.stack([spmd.ppermute(xb, p) for p in perms], dim=1)

        return run_sharded(
            self.comm, ("topo", "neighbor_allgather", len(perms)), body,
            self.comm._buf(x),
        )

    def neighbor_alltoall(self, x):
        """MPI_Neighbor_alltoall: x is (size, n_neighbors, ...) — block
        j goes to neighbor slot j; received blocks keep slot order."""
        perms = self.neighbor_perms()
        nn = len(perms)
        x = self.comm._buf(x)
        if x.dim() < 2 or x.shape[1] != nn:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"neighbor_alltoall needs {nn} blocks per rank",
            )

        # slot j (dim, disp) is filled from the OPPOSITE slot at the
        # neighbor: what a rank sends "left" arrives at its left
        # neighbor's "right" slot
        def body(xb):
            return torch.stack([spmd.ppermute(xb[:, j ^ 1], p)
                                for j, p in enumerate(perms)], dim=1)

        return run_sharded(
            self.comm, ("topo", "neighbor_alltoall", nn), body, x
        )


# ---------------------------------------------------------------------------
# ragged neighborhoods (graph / dist-graph): static ppermute rounds
# ---------------------------------------------------------------------------
#
# A cart topology's neighbor slots are uniform, so each slot is one
# gather. Graph/dist-graph adjacency is ragged: the edge set is greedily
# edge-colored into ROUNDS where every rank sends at most one block and
# receives at most one block — each round is then a legal (partial)
# permutation, and the whole collective is one body of len(rounds)
# gathers with constant slot tables (the libnbc round-schedule idea,
# nbc_ineighbor_allgather.c).


class _NeighborSchedule:
    """Edge-colored schedule for one (in_neighbors, out_neighbors)."""

    def __init__(self, in_neighbors: List[List[int]],
                 out_neighbors: List[List[int]]) -> None:
        n = len(in_neighbors)
        self.n = n
        self.in_neighbors = [list(x) for x in in_neighbors]
        self.out_neighbors = [list(x) for x in out_neighbors]
        self.max_in = max((len(x) for x in in_neighbors), default=0)
        self.max_out = max((len(x) for x in out_neighbors), default=0)

        # edge list with slot indices matched by occurrence order
        # (duplicate edges pair up first-to-first, MPI buffer order)
        out_cursor: Dict[Tuple[int, int], int] = {}
        edges = []  # (src, dst, send_slot, recv_slot)
        for dst in range(n):
            for recv_slot, src in enumerate(self.in_neighbors[dst]):
                k = out_cursor.get((src, dst), 0)
                # find the (k+1)-th occurrence of dst in src's out list
                seen = -1
                send_slot = -1
                for j, d in enumerate(self.out_neighbors[src]):
                    if d == dst:
                        seen += 1
                        if seen == k:
                            send_slot = j
                            break
                if send_slot < 0:
                    raise MPIError(
                        ErrorCode.ERR_TOPOLOGY,
                        f"edge {src}->{dst} in rank {dst}'s sources has "
                        f"no matching entry in rank {src}'s destinations",
                    )
                out_cursor[(src, dst)] = k + 1
                edges.append((src, dst, send_slot, recv_slot))
        for src in range(n):
            for dst in self.out_neighbors[src]:
                if out_cursor.get((src, dst), 0) != \
                        self.out_neighbors[src].count(dst) or \
                        self.in_neighbors[dst].count(src) != \
                        self.out_neighbors[src].count(dst):
                    raise MPIError(
                        ErrorCode.ERR_TOPOLOGY,
                        f"edge {src}->{dst} in destinations has no "
                        "matching entry in the target's sources",
                    )

        # greedy edge coloring: each round is a partial permutation
        self.rounds: List[List[Tuple[int, int]]] = []
        self.send_slots: List[List[int]] = []  # per round: [n] (-1 none)
        self.recv_slots: List[List[int]] = []
        remaining = edges
        while remaining:
            used_src, used_dst = set(), set()
            this, rest = [], []
            for e in remaining:
                if e[0] not in used_src and e[1] not in used_dst:
                    this.append(e)
                    used_src.add(e[0])
                    used_dst.add(e[1])
                else:
                    rest.append(e)
            self.rounds.append([(e[0], e[1]) for e in this])
            ss = [-1] * n
            rs = [-1] * n
            for src, dst, send_slot, recv_slot in this:
                ss[src] = send_slot
                rs[dst] = recv_slot
            self.send_slots.append(ss)
            self.recv_slots.append(rs)
            remaining = rest

    def key(self) -> Tuple:
        return (
            tuple(tuple(x) for x in self.in_neighbors),
            tuple(tuple(x) for x in self.out_neighbors),
        )


def _place(out: torch.Tensor, recv: torch.Tensor,
           slots: Sequence[int]) -> None:
    """Rank r's received block into ``out[r, slots[r]]`` (ranks whose
    slot is -1 received nothing this round): the reference's one-hot
    ``jnp.where`` placement as an index scatter."""
    rows = [r for r, s in enumerate(slots) if s >= 0]
    if rows:
        ri = spmd._idx(rows, out.device)
        out[ri, spmd._idx([slots[r] for r in rows], out.device)] = \
            recv.index_select(0, ri)


def _neighbor_allgather_ragged(comm, sched: _NeighborSchedule, x):
    """Each rank's single block delivered to all its out-neighbors;
    rank r receives into slot i the block from in_neighbors[r][i].
    Returns (size, max_in, ...) with zeros in unused slots."""
    max_in = max(sched.max_in, 1)
    rounds, recv_tables = sched.rounds, sched.recv_slots

    def body(xb):
        out = xb.new_zeros((xb.shape[0], max_in) + tuple(xb.shape[1:]))
        for perm, slots in zip(rounds, recv_tables):
            _place(out, spmd.ppermute(xb, perm), slots)
        return out

    return run_sharded(
        comm, ("topo", "graph_neighbor_allgather", sched.key()), body,
        comm._buf(x),
    )


def _neighbor_alltoall_ragged(comm, sched: _NeighborSchedule, x):
    """x: (size, max_out, ...) — rank r's block j goes to
    out_neighbors[r][j]. Returns (size, max_in, ...)."""
    max_in = max(sched.max_in, 1)
    max_out = max(sched.max_out, 1)
    x = comm._buf(x)
    if x.dim() < 2 or x.shape[1] != max_out:
        raise MPIError(
            ErrorCode.ERR_COUNT,
            f"neighbor_alltoall needs (size, {max_out}, ...) — "
            f"{max_out} send blocks per rank (max out-degree), got "
            f"shape {tuple(x.shape)}",
        )
    rounds = sched.rounds
    send_tables, recv_tables = sched.send_slots, sched.recv_slots

    def body(xb):  # xb: (size, max_out, ...)
        n = xb.shape[0]
        out = xb.new_zeros((n, max_in) + tuple(xb.shape[2:]))
        rows = spmd._ranks(n, xb.device)
        for perm, ss, rs in zip(rounds, send_tables, recv_tables):
            send = xb[rows, spmd._idx([max(s, 0) for s in ss], xb.device)]
            _place(out, spmd.ppermute(send, perm), rs)
        return out

    return run_sharded(
        comm, ("topo", "graph_neighbor_alltoall", sched.key()), body, x
    )


class GraphTopo(_NonblockingNeighborsMixin):
    """MPI_Graph_create analogue (index/edges arrays) WITH neighborhood
    collectives over the ragged adjacency (the reference supports
    neighborhood collectives on all three topology kinds,
    ``nbc_ineighbor_allgather.c``)."""

    def __init__(self, comm, index: Sequence[int],
                 edges: Sequence[int]) -> None:
        self.comm = comm
        self.index = tuple(index)
        self.edges = tuple(edges)
        if len(index) != comm.size:
            raise MPIError(
                ErrorCode.ERR_TOPOLOGY,
                f"graph index length {len(index)} != comm size",
            )
        self._sched: Optional[_NeighborSchedule] = None

    def neighbors(self, rank: int) -> List[int]:
        lo = self.index[rank - 1] if rank else 0
        return list(self.edges[lo:self.index[rank]])

    @property
    def max_degree(self) -> int:
        return self._schedule().max_in

    def _schedule(self) -> _NeighborSchedule:
        # MPI graph neighborhoods send to and receive from the same
        # neighbor list (the graph must be symmetric for the collectives
        # to be well-defined — validated by the schedule's edge matching)
        if self._sched is None:
            adj = [self.neighbors(r) for r in range(self.comm.size)]
            self._sched = _NeighborSchedule(adj, adj)
        return self._sched

    def neighbor_allgather(self, x):
        """Driver mode: x (size, ...) -> (size, max_degree, ...); rank
        r's slot i holds the block from neighbors(r)[i]."""
        return _neighbor_allgather_ragged(self.comm, self._schedule(), x)

    def neighbor_alltoall(self, x):
        """x (size, max_degree, ...): rank r's block j goes to
        neighbors(r)[j]; slot i of the result came from
        neighbors(r)[i]."""
        return _neighbor_alltoall_ragged(self.comm, self._schedule(), x)


class DistGraphTopo(_NonblockingNeighborsMixin):
    """MPI_Dist_graph_create_adjacent analogue (driver mode: per-rank
    adjacency, one controller playing every rank) with neighborhood
    collectives over the directed ragged edge set."""

    def __init__(self, comm, sources: Sequence[Sequence[int]],
                 destinations: Sequence[Sequence[int]]) -> None:
        self.comm = comm
        if len(sources) != comm.size or len(destinations) != comm.size:
            raise MPIError(
                ErrorCode.ERR_TOPOLOGY,
                "dist graph needs per-rank sources/destinations lists "
                f"of length {comm.size}",
            )
        self.sources = tuple(tuple(int(s) for s in x) for x in sources)
        self.destinations = tuple(
            tuple(int(d) for d in x) for x in destinations
        )
        # validates that every source entry has a matching destination
        self._sched = _NeighborSchedule(
            [list(x) for x in self.sources],
            [list(x) for x in self.destinations],
        )

    def in_neighbors(self, rank: int) -> List[int]:
        return list(self.sources[rank])

    def out_neighbors(self, rank: int) -> List[int]:
        return list(self.destinations[rank])

    @property
    def max_in_degree(self) -> int:
        return self._sched.max_in

    @property
    def max_out_degree(self) -> int:
        return self._sched.max_out

    def neighbor_allgather(self, x):
        """x (size, ...) -> (size, max_in_degree, ...): rank r's slot i
        holds the block from sources[r][i]."""
        return _neighbor_allgather_ragged(self.comm, self._sched, x)

    def neighbor_alltoall(self, x):
        """x (size, max_out_degree, ...): rank r's block j goes to
        destinations[r][j]; result slot i came from sources[r][i]."""
        return _neighbor_alltoall_ragged(self.comm, self._sched, x)


def cart_create(comm, dims: Sequence[int],
                periods: Optional[Sequence[bool]] = None,
                reorder: bool = True):
    """MPI_Cart_create: dup the comm, attach a cart topology. Ranks keep
    their order (``reorder`` is accepted; virtual ranks on one card have
    no placement to improve)."""
    dims = dims_create(comm.size, len(dims), dims)
    if periods is None:
        periods = [False] * len(dims)
    c = comm.dup(name=f"cart{tuple(dims)}")
    topo = CartTopo(c, dims, periods)
    c.topo = topo
    return c, topo


def graph_create(comm, index: Sequence[int], edges: Sequence[int]):
    c = comm.dup(name="graph")
    topo = GraphTopo(c, index, edges)
    c.topo = topo
    return c, topo


def dist_graph_create_adjacent(comm, sources: Sequence[Sequence[int]],
                               destinations: Sequence[Sequence[int]]):
    c = comm.dup(name="dist_graph")
    topo = DistGraphTopo(c, sources, destinations)
    c.topo = topo
    return c, topo
