"""Topology-aware inter-process schedules — multi-ring striping and
2D-torus decomposition for the spanning collectives.

(The port's copy of ``ompi_release_tpu/coll/topo_schedules.py``,
which imports no JAX.)

The schedules in :mod:`.hier_schedules` treat every inter-process link
as uniform; the modex host identity knows better. This module adds the
schedule family that exploits it, in the same PURE form (driven only
through the exchange adapter, deterministic functions of
``(procs, me, sizes, host_of)`` — the lockstep parity harness and the
fleet simulator run them unmodified):

``multiring``  (allreduce)
    k concurrent rings over DISJOINT neighbor permutations (stride-s
    successor maps for k units s coprime to P — distinct strides give
    every process k distinct successors), the buffer striped k ways.
    Each round posts one chunk per ring, so a bandwidth-bound fabric
    sees ~k links driven in parallel where the single ring serialized
    one: same ~2n bytes per process, 2(P-1) rounds, k× ring bandwidth.

``torus2d``  (allreduce / allgather / bcast)
    ``topo.dims_create``-style factorization P = d0 × d1 with dim 0
    PINNED to intra-host links by the ``host_of`` grouping (uniform
    host groups of d0 processes across d1 hosts — :func:`torus_grid`
    returns None for ragged layouts and the schedules degrade to the
    flat ring). Allreduce: ring reduce-scatter along dim 0 (shm), ring
    allreduce of the 1/d0-sized partial along dim 1 (DCN), ring
    allgather along dim 0 — DCN carries ONLY the 1/d0-sized partials,
    exactly 2(d1-1)·ceil(ceil(n/d0)/d1) elements per process
    (:func:`torus_inter_bytes_per_rank`), a d0× cut of the flat ring's
    per-boundary-NIC bytes and strictly fewer total inter-host bytes
    (:func:`flat_ring_inter_bytes_total` gives the flat baseline the
    fleet tests compare closed-form). Allgather: dim-1 ring of own
    blocks (DCN moves single blocks), then a dim-0 multi-block ring
    (shm moves the aggregates). Bcast: binomial over one
    representative per host (DCN: d1-1 sends total), then binomial
    within each host (shm).

Reduction-order discipline is inherited: ``multiring``/``torus2d``
allreduce fold chunks in rotated order and pad with the op identity,
so they live in :data:`.hier_schedules.ORDER_WAIVING` — commutative
ops with an identity only, with the same forcing-raises /
rule-downgrades guard semantics the leader tier pinned.
"""

from __future__ import annotations

import math
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import obs as _obs
from ..mca import pvar
from . import hier_schedules as _hs
from .hier_schedules import _concat, _flat, _round

#: topology-aware schedule executions (one bump per completed run) —
#: the auditable "the topo family actually engaged" counter
_topo_runs = pvar.counter(
    "hier_topo_schedule_runs",
    "topology-aware (multi-ring / 2D-torus) spanning-schedule "
    "executions",
)

#: algorithm names this module serves (hier dispatch + the
#: leader-tier stand-aside check key off this)
TOPO_ALGS = ("multiring", "torus2d")


# ---------------------------------------------------------------------------
# grids, strides, closed forms
# ---------------------------------------------------------------------------

def torus_grid(procs: List[int], host_of: Dict[int, str]
               ) -> Optional[Tuple[int, int, List[List[int]]]]:
    """(d0, d1, groups) for a UNIFORM host layout of ``procs`` —
    groups (one per host, ordered by lowest member, members sorted by
    process index) of equal size d0 across d1 hosts — or None when the
    layout is ragged or spans a single host (no torus to exploit).
    Deterministic on every process: derived from the shared modex
    host map alone."""
    by_host: Dict[str, List[int]] = {}
    for p in procs:
        by_host.setdefault(host_of.get(p, f"proc-{p}"), []).append(p)
    groups = sorted((sorted(g) for g in by_host.values()),
                    key=lambda g: g[0])
    d1 = len(groups)
    if d1 < 2:
        return None
    d0 = len(groups[0])
    if any(len(g) != d0 for g in groups):
        return None  # ragged: no uniform torus
    return d0, d1, groups


def grid_dims(procs: List[int],
              host_of: Dict[int, str]) -> Optional[Tuple[int, int]]:
    """(d0, d1) of the uniform torus over ``procs``, or None — what
    ``pick(..., topo=)`` consumes."""
    g = torus_grid(procs, host_of)
    return (g[0], g[1]) if g else None


def ring_strides(P: int, k: int) -> List[int]:
    """Up to ``k`` stride values coprime to P (stride 1 first): each
    defines one single-cycle ring, and distinct strides give every
    process pairwise-distinct successors AND predecessors — the
    disjoint neighbor permutations multiring stripes across."""
    out = [s for s in range(1, P) if math.gcd(s, P) == 1]
    return out[:max(1, int(k))]


def torus_rounds(d0: int, d1: int) -> int:
    """Exchange rounds of the torus allreduce: dim-0 reduce-scatter +
    dim-1 ring allreduce + dim-0 allgather."""
    return 2 * (d0 - 1) + 2 * (d1 - 1)


def torus_inter_bytes_per_rank(n_elems: int, itemsize: int,
                               d0: int, d1: int) -> int:
    """Exact host-crossing send bytes per process of the torus
    allreduce: only the dim-1 ring allreduce of the 1/d0-sized partial
    crosses DCN — 2(d1-1) chunks of ceil(ceil(n/d0)/d1) elements."""
    per0 = max(1, -(-int(n_elems) // d0))
    per1 = max(1, -(-per0 // d1))
    return 2 * (d1 - 1) * per1 * int(itemsize)


def torus_inter_bytes_total(n_elems: int, itemsize: int,
                            d0: int, d1: int) -> int:
    return d0 * d1 * torus_inter_bytes_per_rank(n_elems, itemsize,
                                                d0, d1)


def flat_ring_inter_bytes_total(n_elems: int, itemsize: int,
                                P: int, hosts: int) -> int:
    """Exact host-crossing send bytes of the FLAT ring allreduce over
    contiguous equal host groups: the ring crosses hosts at exactly
    ``hosts`` boundary processes, each shipping every one of its
    2(P-1) chunks of ceil(n/P) elements across DCN. The closed-form
    baseline the torus variant is asserted strictly below (total) and
    ~d0× below (per boundary NIC)."""
    per = max(1, -(-int(n_elems) // P))
    return hosts * 2 * (P - 1) * per * int(itemsize)


# ---------------------------------------------------------------------------
# shared ring fragments
# ---------------------------------------------------------------------------

def _pad_flat(mine, slots: int, identity) -> Tuple[np.ndarray, int, int]:
    """(flat padded to per*slots elements, original length, per)."""
    flat = _flat(mine)
    L = flat.shape[0]
    per = max(1, -(-L // slots))
    if per * slots != L:
        flat = np.concatenate(
            [flat, np.full(per * slots - L, identity, flat.dtype)])
    elif not flat.flags.writeable:
        flat = flat.copy()
    return flat, L, per


def _ring_reduce_scatter(x, ring: List[int], mi: int,
                         chunks: List[np.ndarray], op: Callable) -> int:
    """In-place ring reduce-scatter over ``ring``: P-1 rounds, chunk
    fold order the fixed rotation (commutative ops only — callers sit
    behind the ORDER_WAIVING guard). Returns the chunk position this
    member owns fully reduced, (mi+1) % P."""
    P = len(ring)
    nxt, prv = ring[(mi + 1) % P], ring[(mi - 1) % P]
    for s in range(P - 1):
        cs = (mi - s) % P
        cr = (mi - s - 1) % P
        got = _round(x, {nxt: [chunks[cs]]}, {prv: 1})[prv][0]
        chunks[cr] = np.asarray(op(_flat(got), chunks[cr]))
    return (mi + 1) % P


def _allgather_ring_multi(x, ring: List[int], mi: int,
                          arrs: List[np.ndarray]) -> List[List[np.ndarray]]:
    """Ring allgather of a LIST of blocks per member (m messages per
    round, per-peer FIFO keeps list order). Returns per-position block
    lists in ring-position order."""
    P = len(ring)
    m = len(arrs)
    nxt, prv = ring[(mi + 1) % P], ring[(mi - 1) % P]
    blocks: Dict[int, List[np.ndarray]] = {
        mi: [np.asarray(a) for a in arrs]}
    for s in range(P - 1):
        cs = (mi - s) % P
        cr = (mi - s - 1) % P
        got = _round(x, {nxt: list(blocks[cs])}, {prv: m})
        blocks[cr] = [np.asarray(a) for a in got[prv]]
    return [blocks[i] for i in range(P)]


def _coords(grid: Tuple[int, int, List[List[int]]],
            me: int) -> Tuple[int, int]:
    """(intra position, group index) of ``me`` in the grid."""
    d0, d1, groups = grid
    for gj, g in enumerate(groups):
        if me in g:
            return g.index(me), gj
    raise ValueError(f"process {me} not in the torus grid")


# ---------------------------------------------------------------------------
# multi-ring striped allreduce
# ---------------------------------------------------------------------------

def allreduce_multiring(x, procs: List[int], me: int, mine,
                        op: Callable, identity, k: int = 4) -> np.ndarray:
    """k-ring striped allreduce: the buffer splits into k stripes,
    stripe j ring-reduce-scatter+allgathers over the stride-s_j ring,
    and every round posts all k stripes' chunks at once — k disjoint
    links driven in parallel per round. Degrades to the single ring
    when P admits fewer than 2 coprime strides. Commutative ops with
    an identity only (``pick`` enforces via ORDER_WAIVING)."""
    P = len(procs)
    if P == 1:
        return _flat(mine)
    strides = ring_strides(P, k)
    if len(strides) < 2:
        return _hs.allreduce_ring(x, procs, me, mine, op, identity)
    k = len(strides)
    rec = _obs.enabled
    t0 = _time.perf_counter() if rec else 0.0
    mi = procs.index(me)
    flat, L, per = _pad_flat(mine, k * P, identity)
    # chunks[j][c]: stripe j's chunk at ring position c
    chunks = [[flat[(j * P + c) * per:(j * P + c + 1) * per].copy()
               for c in range(P)] for j in range(k)]
    # my position on ring j: walking from 0 by stride s_j reaches mi
    # after (mi * s_j^-1) mod P steps; successor/predecessor are the
    # stride neighbors (pairwise distinct across rings)
    pos = [(mi * pow(s, -1, P)) % P for s in strides]
    nxt = [procs[(mi + s) % P] for s in strides]
    prv = [procs[(mi - s) % P] for s in strides]
    for s_ in range(P - 1):  # reduce-scatter, k rings per round
        sends = {nxt[j]: [chunks[j][(pos[j] - s_) % P]]
                 for j in range(k)}
        got = _round(x, sends, {prv[j]: 1 for j in range(k)})
        for j in range(k):
            cr = (pos[j] - s_ - 1) % P
            g = _flat(got[prv[j]][0])
            chunks[j][cr] = np.asarray(op(g, chunks[j][cr]))
    for s_ in range(P - 1):  # allgather of the reduced chunks
        sends = {nxt[j]: [chunks[j][(pos[j] + 1 - s_) % P]]
                 for j in range(k)}
        got = _round(x, sends, {prv[j]: 1 for j in range(k)})
        for j in range(k):
            cr = (pos[j] - s_) % P
            chunks[j][cr] = _flat(got[prv[j]][0])
    out = np.concatenate([chunks[j][c]
                          for j in range(k) for c in range(P)])[:L]
    _topo_runs.add()
    if rec and _obs.enabled:
        _obs.record("topo_allreduce_multiring", "hier", t0,
                    _time.perf_counter() - t0, nbytes=int(out.nbytes))
    return out


# ---------------------------------------------------------------------------
# 2D torus: allreduce / allgather / bcast
# ---------------------------------------------------------------------------

def allreduce_torus2d(x, procs: List[int], me: int, mine,
                      op: Callable, identity,
                      host_of: Dict[int, str]) -> np.ndarray:
    """2D-torus allreduce: reduce-scatter along the intra-host dim,
    ring allreduce of the 1/d0 partial along the inter-host dim, ring
    allgather back along the intra dim. DCN carries only the dim-1
    phase — :func:`torus_inter_bytes_per_rank` exactly. Falls back to
    the flat ring on ragged or single-host layouts (and on d0 == 1,
    where the torus IS the flat ring over hosts)."""
    grid = torus_grid(procs, host_of)
    if grid is None or grid[0] == 1:
        return _hs.allreduce_ring(x, procs, me, mine, op, identity)
    d0, d1, groups = grid
    rec = _obs.enabled
    t0 = _time.perf_counter() if rec else 0.0
    gi, gj = _coords(grid, me)
    group = groups[gj]
    column = [groups[j][gi] for j in range(d1)]
    flat, L, per0 = _pad_flat(mine, d0, identity)
    chunks = [flat[c * per0:(c + 1) * per0].copy() for c in range(d0)]
    own = _ring_reduce_scatter(x, group, gi, chunks, op)   # shm
    part = _hs.allreduce_ring(x, column, me, chunks[own],  # DCN
                              op, identity)
    got = _hs.allgather_ring(x, group, me, np.asarray(part))  # shm
    # intra position i owns chunk (i+1) % d0 after the reduce-scatter
    out = np.concatenate([_flat(got[(c - 1) % d0])
                          for c in range(d0)])[:L]
    _topo_runs.add()
    if rec and _obs.enabled:
        _obs.record("topo_allreduce_torus2d", "hier", t0,
                    _time.perf_counter() - t0, nbytes=int(out.nbytes))
    return out


def allgather_torus2d(x, procs: List[int], me: int, mine,
                      host_of: Dict[int, str]) -> List[np.ndarray]:
    """2D-torus allgather: ring allgather of single blocks along the
    inter-host dim (DCN moves (d1-1) blocks per process instead of a
    boundary NIC moving P-1), then a multi-block ring along the intra
    dim distributes the column aggregates over shm. Blocks may differ
    in shape (they ride the wire). Returns blocks in process-index
    order, exactly like :func:`.hier_schedules.allgather_ring`."""
    grid = torus_grid(procs, host_of)
    if grid is None:
        return _hs.allgather_ring(x, procs, me, mine)
    d0, d1, groups = grid
    rec = _obs.enabled
    t0 = _time.perf_counter() if rec else 0.0
    gi, gj = _coords(grid, me)
    column = [groups[j][gi] for j in range(d1)]
    col_blocks = _hs.allgather_ring(x, column, me, np.asarray(mine))
    group = groups[gj]
    if d0 > 1:
        rows = _allgather_ring_multi(x, group, gi, col_blocks)
    else:
        rows = [col_blocks]
    block_of: Dict[int, np.ndarray] = {}
    for i in range(d0):
        for j in range(d1):
            block_of[groups[j][i]] = np.asarray(rows[i][j])
    out = [block_of[p] for p in procs]
    _topo_runs.add()
    if rec and _obs.enabled:
        _obs.record("topo_allgather_torus2d", "hier", t0,
                    _time.perf_counter() - t0,
                    nbytes=sum(int(b.nbytes) for b in out))
    return out


def bcast_torus2d(x, procs: List[int], me: int, root: int, val,
                  host_of: Dict[int, str]):
    """2D-torus bcast: binomial over one representative per host (the
    root represents its own host), then binomial within each host —
    DCN carries exactly d1-1 copies total, shm the rest. ``val`` is
    read on the root only."""
    grid = torus_grid(procs, host_of)
    if grid is None:
        return _hs.bcast_binomial(x, procs, me, root, val)
    d0, d1, groups = grid
    rec = _obs.enabled
    t0 = _time.perf_counter() if rec else 0.0
    _, gj = _coords(grid, me)
    _, rj = _coords(grid, root)
    reps = sorted({root} | {groups[j][0] for j in range(d1)
                            if j != rj})
    if me in reps:
        val = _hs.bcast_binomial(x, reps, me, root, val)
    group = groups[gj]
    rep = root if gj == rj else groups[gj][0]
    if len(group) > 1:
        val = _hs.bcast_binomial(x, group, me, rep, val)
    val = np.asarray(val)
    _topo_runs.add()
    if rec and _obs.enabled:
        _obs.record("topo_bcast_torus2d", "hier", t0,
                    _time.perf_counter() - t0, nbytes=int(val.nbytes))
    return val
