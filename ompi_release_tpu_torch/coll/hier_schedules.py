"""Scheduled inter-process algorithms for the spanning (hier)
collectives — the ``coll/tuned`` algorithm menu recast for the
process-combine step of ``coll/hier.py``.

(The port's copy of ``ompi_release_tpu/coll/hier_schedules.py``,
which imports no JAX.)

Every function here is a PURE schedule: it speaks to the wire only
through an exchange adapter (one call per schedule round, posting all
of the round's sends before reaping its receives), so the same code is
driven by the real :class:`~.hier._HierModule` transport in a
``tpurun`` job and by the lockstep in-memory simulator the parity
tests use. Schedules are deterministic functions of
``(procs, me, sizes)`` alone — both sides of every message compute the
identical round plan, which is what keeps the PR-4 trace-context
contract intact (flow ids derive from per-pair message indices that
advance in lockstep) and what lets packed multi-block payloads be
split without shipping any layout metadata.

Algorithm menu (``pick`` resolves forcing > dynamic rules > fixed
decision constants, the tuned precedence):

==========  ==========================================================
allreduce   ``linear`` (all-pairs partial exchange, the historic
            path), ``recursive_doubling`` (doubling-distance Bruck
            allgather of partials + a LOCAL fold in process-index
            order — ceil(log2 P) messages, bitwise-identical to
            linear for every op including non-commutative ones),
            ``ring`` (ring reduce-scatter + ring allgather, ~2n bytes
            per process), ``rabenseifner`` (recursive-halving
            reduce-scatter + recursive-doubling allgather; power-of-
            two process counts, else it degrades to ring),
            ``multiring`` / ``torus2d`` (topology-aware striped /
            2D-torus variants, :mod:`coll.topo_schedules`)
bcast       ``linear``, ``binomial`` (ceil(log2 P)-depth tree),
            ``torus2d`` (host-representative tree, DCN ships d1-1
            copies)
reduce      ``linear`` (direct partial gather to the root's owner),
            ``binomial`` (tree gather of per-process partials; the
            fold happens ONCE at the root in process-index order, so
            both are bitwise-identical to each other and safe for
            non-commutative ops)
allgather   ``linear``, ``bruck`` (log rounds, packed doubling
            payloads), ``ring`` (neighbor-only passes)
alltoall    ``linear``, ``bruck`` (log rounds, store-and-forward),
            ``pairwise`` (P-1 rounds, send to me+k / recv from me-k)
gather      ``linear``, ``binomial``
scatter     ``linear``, ``binomial``
==========  ==========================================================

Reduction-order discipline (the coll/tuned rule): ``ring`` and
``rabenseifner`` fold chunks in rotated/halving order and pad with the
op identity, so they are only ever selected for commutative ops with
an identity; a dynamic rule naming them for anything else is silently
downgraded to ``recursive_doubling`` (a config file cannot waive MPI
semantics), while operator FORCING via ``hier_inter_algorithm`` raises
loudly. Everything else preserves the exact process-index fold order
of the linear path and is bitwise-identical to it.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import obs as _obs
from ..mca import pvar
from ..mca import var as mca_var
from ..utils import output
from ..utils.errors import ErrorCode, MPIError

_log = output.stream("coll")

#: schedule rounds executed (one exchange call = one round) — the
#: auditable counterpart of the O(P^2) -> O(log P) round-count claim
_sched_rounds = pvar.counter(
    "hier_schedule_rounds",
    "inter-process schedule rounds executed by spanning collectives",
)

#: collective -> algorithms a ``hier_<coll>`` dynamic rule may name
#: (registered into dynamic_rules.RULE_COLLECTIVES by coll/components)
ALGORITHMS: Dict[str, tuple] = {
    "allreduce": ("auto", "linear", "recursive_doubling", "ring",
                  "rabenseifner", "multiring", "torus2d"),
    "bcast": ("auto", "linear", "binomial", "torus2d"),
    "reduce": ("auto", "linear", "binomial"),
    "allgather": ("auto", "linear", "bruck", "ring", "torus2d"),
    "alltoall": ("auto", "linear", "bruck", "pairwise"),
    "gather": ("auto", "linear", "binomial"),
    "scatter": ("auto", "linear", "binomial"),
}

#: allreduce algorithms that reorder the fold and pad with the
#: identity (the topology-aware variants stripe/decompose the buffer,
#: so they inherit the exact same commutative-only guard semantics)
ORDER_WAIVING = ("ring", "rabenseifner", "multiring", "torus2d")


def _register_rule_namespaces() -> None:
    """``hier_<coll>`` dynamic-rule namespaces (min_comm_size matches
    the PROCESS count; min_msg_bytes the inter decision unit — see
    :func:`pick`). Registered here, not in components.py, so a rule
    file naming them parses wherever this module is importable."""
    from . import dynamic_rules

    dynamic_rules.RULE_COLLECTIVES.update({
        f"hier_{coll}": algs for coll, algs in ALGORITHMS.items()
    })


_register_rule_namespaces()


def register_vars() -> None:
    mca_var.register(
        "hier_inter_algorithm", "str", "auto",
        "Force one inter-process schedule for spanning collectives "
        "(hier). Applied to every collective whose menu contains the "
        "name; others keep auto selection. See "
        "coll/hier_schedules.ALGORITHMS for the menus.",
    )
    mca_var.register(
        "hier_small_message", "size", 65536,
        "Inter-message bytes below which latency-bound schedules win "
        "the fixed decision (allreduce recursive_doubling, "
        "reduce/gather/scatter binomial, alltoall bruck)",
    )
    mca_var.register(
        "hier_bruck_cutoff", "size", 262144,
        "Total allgather bytes below which the fixed decision picks "
        "bruck's packed log-round schedule over the linear exchange",
    )
    mca_var.register(
        "hier_leader_tier", "bool", True,
        "Host-aware leader tier for spanning allreduce-combines and "
        "bcast: co-hosted processes combine/fan out over shm first, "
        "one leader per host crosses DCN (coll/ml subgrouping). "
        "Active only when the job spans >1 host with >1 process on "
        "some host; commutative ops only.",
    )
    mca_var.register(
        "hier_topo_schedules", "bool", True,
        "Let the fixed decision constants pick the topology-aware "
        "schedules (2D-torus allreduce/allgather/bcast) when the job "
        "spans a uniform multi-host grid — DCN then carries only the "
        "1/dim0-sized partials. False restores the flat decisions; "
        "forcing and dynamic rules can still name the variants.",
    )
    mca_var.register(
        "hier_multiring_k", "int", 4,
        "Ring count for the multiring striped allreduce (disjoint "
        "stride-coprime neighbor permutations; the effective count is "
        "capped by the units available mod P). Selected via forcing "
        "or a hier_allreduce dynamic rule naming 'multiring'.",
    )


register_vars()  # idempotent; cvars must exist before the first pick


# ---------------------------------------------------------------------------
# selection: forcing > dynamic rules > fixed decision constants
# ---------------------------------------------------------------------------

def _topo_ok(topo: Optional[tuple]) -> bool:
    """A (d0, d1) uniform grid worth exploiting: both dims non-trivial
    and the operator has not opted out."""
    return (topo is not None and int(topo[0]) > 1 and int(topo[1]) > 1
            and bool(mca_var.get("hier_topo_schedules", True)))


def pick(coll: str, nprocs: int, nbytes: int, *,
         commutative: bool = True, has_identity: bool = True,
         pair_op: bool = False,
         topo: Optional[tuple] = None) -> str:
    """The inter algorithm for this call. ``nprocs`` is the PROCESS
    count of the spanning comm (what a ``hier_<coll>`` rule's
    min_comm_size column matches against — the inter step never sees
    ranks), ``nbytes`` the collective's inter decision unit
    (allreduce/reduce/bcast/gather/scatter: one partial/block's bytes;
    allgather: total bytes across processes; alltoall: bytes per
    destination-process block). MINLOC/MAXLOC calls pass ``pair_op``:
    the chunked schedules have no (value, index) variant, so an
    order-waiving pick quietly becomes ``recursive_doubling`` even
    when forced — whereas forcing ring/rabenseifner for a
    NON-COMMUTATIVE op is a semantics violation and raises. ``topo``
    is the comm's uniform (d0, d1) host grid or None: the fixed
    decision prefers the 2D-torus variants when one exists (DCN
    carries 1/d0-sized partials), gated by ``hier_topo_schedules``."""
    from . import dynamic_rules

    menu = ALGORITHMS[coll]
    forced = mca_var.get("hier_inter_algorithm", "auto")
    if forced and forced != "auto":
        if forced in menu:
            if coll == "allreduce" and forced in ORDER_WAIVING:
                if pair_op:
                    _log.verbose(
                        3, f"hier_inter_algorithm={forced}: no pair-op "
                           "variant; recursive_doubling applies")
                    return "recursive_doubling"
                if not (commutative and has_identity):
                    raise MPIError(
                        ErrorCode.ERR_ARG,
                        f"hier_inter_algorithm={forced}: {forced} "
                        "allreduce folds chunks in rotated order and "
                        "pads with the op identity; use "
                        "recursive_doubling or linear for this op",
                    )
            return forced
        _log.verbose(
            3, f"hier_inter_algorithm={forced} has no {coll} variant; "
               f"auto selection applies")
    dyn = dynamic_rules.lookup(f"hier_{coll}", nprocs, nbytes)
    if dyn is not None:
        if coll == "allreduce" and dyn in ORDER_WAIVING \
                and not (commutative and has_identity and not pair_op):
            # same guard as coll/tuned: a rule file cannot waive MPI
            # semantics — downgrade to the exact-order fallback
            dyn = "recursive_doubling"
        return dyn
    # fixed decision constants
    small = int(mca_var.get("hier_small_message", 65536))
    if coll == "allreduce":
        # pair_op checked here too: a user Op CAN carry is_pair_op
        # together with an identity, and the chunked schedules have no
        # (value, index) variant regardless
        if nbytes < small or pair_op \
                or not (commutative and has_identity):
            return "recursive_doubling"
        if _topo_ok(topo):
            return "torus2d"
        return "rabenseifner" if nprocs & (nprocs - 1) == 0 else "ring"
    if coll == "bcast":
        # the torus bcast's DCN cost is d1-1 copies at log-depth for
        # any size, strictly below the flat binomial's host-oblivious
        # edge set — no size threshold needed
        return "torus2d" if _topo_ok(topo) else "binomial"
    if coll in ("reduce", "gather", "scatter"):
        return "binomial" if nbytes < small else "linear"
    if coll == "allgather":
        cutoff = int(mca_var.get("hier_bruck_cutoff", 262144))
        if nbytes < cutoff:
            return "bruck"
        return "torus2d" if _topo_ok(topo) else "linear"
    if coll == "alltoall":
        return "bruck" if nbytes < small else "pairwise"
    return "linear"


# ---------------------------------------------------------------------------
# round plumbing
# ---------------------------------------------------------------------------

def _round(x, sends: Dict[int, List[np.ndarray]],
           recvs: Dict[int, int]) -> Dict[int, List[np.ndarray]]:
    """One schedule round: post every send, reap every receive. The
    adapter owns transport, pvars, flow ids, and the watchdog wait
    registry; this wrapper adds the round counter and (gated) a
    round-granularity span."""
    _sched_rounds.add()
    rec = _obs.enabled
    t0 = _time.perf_counter() if rec else 0.0
    got = x.exchange(sends, recvs)
    if rec and _obs.enabled:
        _obs.record(
            "hier_sched_round", "hier", t0, _time.perf_counter() - t0,
            nbytes=sum(int(np.asarray(a).nbytes)
                       for arrs in sends.values() for a in arrs),
        )
    return got


def _flat(a) -> np.ndarray:
    a = np.asarray(a)
    return np.ascontiguousarray(a).reshape(-1)


def _concat(arrs: Sequence[np.ndarray], dtype) -> np.ndarray:
    arrs = [np.asarray(a).reshape(-1) for a in arrs]
    if not arrs:
        return np.zeros((0,), dtype)
    if len(arrs) == 1:
        return arrs[0]
    return np.concatenate(arrs)


def round_exchange(x, sends: Dict[int, List[np.ndarray]],
                   recvs: Dict[int, int]) -> Dict[int, List[np.ndarray]]:
    """Public round entry for schedule fragments that live OUTSIDE
    this module (the hier leader tier's fan-in/fan-out stages, the
    direct reduce gather): same counter/span accounting as every
    in-module round, so ``hier_schedule_rounds`` reflects every
    participant of every schedule."""
    return _round(x, sends, recvs)


def linear_exchange(x, procs: List[int], me: int,
                    payload) -> Dict[int, np.ndarray]:
    """The historic all-pairs exchange as ONE schedule round: send
    ``payload`` to every peer, receive one message back from each.
    Returns {peer: array}."""
    peers = [p for p in procs if p != me]
    got = _round(x, {p: [payload] for p in peers},
                 {p: 1 for p in peers})
    return {p: np.asarray(got[p][0]) for p in peers}


# ---------------------------------------------------------------------------
# allgather family (also the partial-exchange engine for allreduce's
# recursive_doubling and the row exchange behind scan/exscan)
# ---------------------------------------------------------------------------

def allgather_bruck(x, procs: List[int], me: int, mine,
                    counts: Sequence[int]) -> List[np.ndarray]:
    """Doubling-distance (Bruck) allgather of one flat block per
    process: ceil(log2 P) rounds, ONE packed payload per round (both
    sides derive the block split from ``counts``, indexed by process
    POSITION). Returns the P flat blocks in process-index order."""
    P = len(procs)
    mi = procs.index(me)
    mine = _flat(mine)
    blocks: Dict[int, np.ndarray] = {mi: mine}
    have = 1
    while have < P:
        n = min(have, P - have)
        dst = procs[(mi - have) % P]
        src = procs[(mi + have) % P]
        payload = _concat([blocks[(mi + t) % P] for t in range(n)],
                          mine.dtype)
        got = _flat(_round(x, {dst: [payload]}, {src: 1})[src][0])
        off = 0
        for t in range(n):
            j = (mi + have + t) % P
            c = int(counts[j])
            blocks[j] = got[off:off + c]
            off += c
        have += n
    return [blocks[i] for i in range(P)]


def allgather_ring(x, procs: List[int], me: int,
                   mine) -> List[np.ndarray]:
    """Neighbor-only ring allgather: P-1 rounds, each passing one
    whole block to the next process (shapes ride the wire, so blocks
    may differ in shape). Returns blocks in process-index order."""
    P = len(procs)
    mi = procs.index(me)
    nxt, prv = procs[(mi + 1) % P], procs[(mi - 1) % P]
    blocks: Dict[int, np.ndarray] = {mi: np.asarray(mine)}
    for s in range(P - 1):
        cs = (mi - s) % P
        cr = (mi - s - 1) % P
        got = _round(x, {nxt: [blocks[cs]]}, {prv: 1})[prv][0]
        blocks[cr] = np.asarray(got)
    return [blocks[i] for i in range(P)]


# ---------------------------------------------------------------------------
# allreduce: ring and Rabenseifner (reduce-scatter + allgather)
# ---------------------------------------------------------------------------

def _pad_chunks(mine, P: int, identity) -> tuple:
    flat = _flat(mine)
    L = flat.shape[0]
    per = max(1, -(-L // P))
    if per * P != L:
        flat = np.concatenate(
            [flat, np.full(per * P - L, identity, flat.dtype)])
    elif not flat.flags.writeable:  # jax-backed views are read-only;
        flat = flat.copy()          # rabenseifner accumulates in place
    return flat, L, per


def allreduce_ring(x, procs: List[int], me: int, mine,
                   op: Callable, identity) -> np.ndarray:
    """Ring reduce-scatter + ring allgather: per-process inter bytes
    drop from (P-1)*n to ~2n. Chunk c's fold order is the fixed
    rotation (c, c+1, ..., c-1) — deterministic and identical on every
    process/run, commutative ops only (``pick`` enforces)."""
    P = len(procs)
    mi = procs.index(me)
    flat, L, per = _pad_chunks(mine, P, identity)
    chunks = [flat[j * per:(j + 1) * per].copy() for j in range(P)]
    nxt, prv = procs[(mi + 1) % P], procs[(mi - 1) % P]
    for s in range(P - 1):  # reduce-scatter
        cs = (mi - s) % P
        cr = (mi - s - 1) % P
        got = _round(x, {nxt: [chunks[cs]]}, {prv: 1})[prv][0]
        # operand order is fixed: the travelling accumulator (earlier
        # ring positions) on the left, my partial on the right
        chunks[cr] = np.asarray(op(_flat(got), chunks[cr]))
    for s in range(P - 1):  # allgather of the reduced chunks
        cs = (mi + 1 - s) % P
        cr = (mi - s) % P
        got = _round(x, {nxt: [chunks[cs]]}, {prv: 1})[prv][0]
        chunks[cr] = _flat(got)
    return np.concatenate(chunks)[:L]


def allreduce_rabenseifner(x, procs: List[int], me: int, mine,
                           op: Callable, identity) -> np.ndarray:
    """Recursive-halving reduce-scatter + recursive-doubling
    allgather (Rabenseifner): ~2n bytes in ceil(2 log2 P) rounds.
    Power-of-two process counts only — callers degrade to
    :func:`allreduce_ring` otherwise. The halving fold keeps a fixed
    operand order (lower process positions left), deterministic across
    ranks and runs; commutative ops only."""
    P = len(procs)
    if P & (P - 1):
        return allreduce_ring(x, procs, me, mine, op, identity)
    mi = procs.index(me)
    flat, L, per = _pad_chunks(mine, P, identity)
    lo, hi = 0, P  # chunk-position range I still accumulate
    d = P // 2
    while d >= 1:  # recursive halving reduce-scatter
        partner = procs[mi ^ d]
        half = (hi - lo) // 2
        if mi & d:
            keep, send = (lo + half, hi), (lo, lo + half)
        else:
            keep, send = (lo, lo + half), (lo + half, hi)
        payload = flat[send[0] * per:send[1] * per]
        got = _flat(_round(x, {partner: [payload]},
                           {partner: 1})[partner][0])
        seg = flat[keep[0] * per:keep[1] * per]
        # fixed operand order: the lower-position accumulator left
        merged = op(got, seg) if mi & d else op(seg, got)
        flat[keep[0] * per:keep[1] * per] = np.asarray(merged)
        lo, hi = keep
        d //= 2
    d = 1
    blk = mi  # owned chunk position (== mi: bits selected top-down)
    while d < P:  # recursive doubling allgather
        partner = procs[mi ^ d]
        plo = blk ^ d
        payload = flat[blk * per:(blk + d) * per]
        got = _flat(_round(x, {partner: [payload]},
                           {partner: 1})[partner][0])
        flat[plo * per:(plo + d) * per] = got
        blk = min(blk, plo)
        d *= 2
    return flat[:L]


# ---------------------------------------------------------------------------
# binomial trees: bcast / gather / scatter (vranks relative to root)
# ---------------------------------------------------------------------------

def bcast_binomial(x, procs: List[int], me: int, root: int, val):
    """Binomial-tree bcast: ceil(log2 P) depth, the root sends exactly
    ceil(log2 P) messages (vs P-1 linear). ``val`` is read on the root
    only; every process returns the broadcast array."""
    P = len(procs)
    mi = procs.index(me)
    ri = procs.index(root)
    vr = (mi - ri) % P
    mask = 1
    while mask < P:
        if vr & mask:
            src = procs[((vr - mask) + ri) % P]
            val = _round(x, {}, {src: 1})[src][0]
            break
        mask <<= 1
    val = np.asarray(val)
    mask >>= 1
    sends: Dict[int, List[np.ndarray]] = {}
    while mask > 0:
        if vr + mask < P:
            dst = procs[((vr + mask) + ri) % P]
            sends[dst] = [val]
        mask >>= 1
    if sends:
        _round(x, sends, {})
    return val


def _subtree(vr: int, mask: int, P: int) -> int:
    """Size of the binomial subtree rooted at vrank ``vr`` when it
    reports at distance ``mask`` (contiguous vranks [vr, vr+size))."""
    return min(mask, P - vr)


def gather_binomial(x, procs: List[int], me: int, root: int, mine,
                    counts: Sequence[int]) -> Optional[List[np.ndarray]]:
    """Binomial-tree gather of one flat block per process to the root:
    every non-root sends exactly ONE packed message (its subtree's
    blocks, vrank-ascending), the root receives ceil(log2 P). Returns
    the P flat blocks in process-index order at the root, None
    elsewhere. ``counts`` is indexed by process POSITION."""
    P = len(procs)
    mi = procs.index(me)
    ri = procs.index(root)
    vr = (mi - ri) % P

    def vcount(v: int) -> int:
        return int(counts[(v + ri) % P])

    held: Dict[int, np.ndarray] = {vr: _flat(mine)}
    mask = 1
    while mask < P:
        if vr & mask:
            parent = procs[((vr - mask) + ri) % P]
            payload = _concat([held[v] for v in sorted(held)],
                              held[vr].dtype)
            _round(x, {parent: [payload]}, {})
            return None
        child = vr + mask
        if child < P:
            src = procs[(child + ri) % P]
            got = _flat(_round(x, {}, {src: 1})[src][0])
            off = 0
            for v in range(child, child + _subtree(child, mask, P)):
                c = vcount(v)
                held[v] = got[off:off + c]
                off += c
        mask <<= 1
    return [held[(i - ri) % P] for i in range(P)]


def scatter_binomial(x, procs: List[int], me: int, root: int,
                     chunks: Optional[List[np.ndarray]],
                     weights: Sequence[int],
                     meta: Optional[np.ndarray] = None) -> tuple:
    """Binomial-tree scatter: the root ships each child its whole
    subtree's chunks in one packed message (plus a small ``meta``
    array forwarded verbatim — the caller's shape header, since
    non-roots must not read the buffer); intermediates peel their own
    span and forward. ``chunks`` (root only) and the returned flat
    chunk are indexed by process POSITION; per-position lengths are
    ``weights[i] * unit`` with ``unit`` inferred from the received
    payload — ``weights`` must be positive and identical everywhere.
    Returns ``(my_flat_chunk, meta)``."""
    P = len(procs)
    mi = procs.index(me)
    ri = procs.index(root)
    vr = (mi - ri) % P

    def vweight(v: int) -> int:
        return int(weights[(v + ri) % P])

    held: Dict[int, np.ndarray] = {}
    mask = 1
    if vr == 0:
        meta = np.asarray([] if meta is None else meta, np.int64)
        for v in range(P):
            held[v] = _flat(chunks[(v + ri) % P])
        while mask < P:
            mask <<= 1
    else:
        while mask < P:
            if vr & mask:
                src = procs[((vr - mask) + ri) % P]
                got = _round(x, {}, {src: 2})[src]
                meta = np.asarray(got[0], np.int64)
                flat = _flat(got[1])
                span = list(range(vr, vr + _subtree(vr, mask, P)))
                wsum = sum(vweight(v) for v in span)
                if wsum <= 0 or flat.shape[0] % wsum:
                    raise MPIError(
                        ErrorCode.ERR_TRUNCATE,
                        f"binomial scatter: payload of {flat.shape[0]} "
                        f"elements does not divide across subtree "
                        f"weights {wsum}",
                    )
                unit = flat.shape[0] // wsum
                off = 0
                for v in span:
                    c = vweight(v) * unit
                    held[v] = flat[off:off + c]
                    off += c
                break
            mask <<= 1
    mask >>= 1
    while mask > 0:
        child = vr + mask
        if child < P:
            dst = procs[(child + ri) % P]
            span = range(child, child + _subtree(child, mask, P))
            payload = _concat([held[v] for v in span], held[vr].dtype)
            _round(x, {dst: [meta, payload]}, {})
        mask >>= 1
    return held[vr], meta


# ---------------------------------------------------------------------------
# alltoall: pairwise exchange and Bruck store-and-forward
# ---------------------------------------------------------------------------

def alltoall_pairwise(x, procs: List[int], me: int,
                      payload_for: Dict[int, np.ndarray]
                      ) -> Dict[int, np.ndarray]:
    """P-1 rounds; round k sends my block to procs[mi+k] and receives
    from procs[mi-k] — the coll_tuned pairwise schedule that bounds
    per-round concurrency for large messages. Payloads are the same
    per-peer aggregates the linear path ships."""
    P = len(procs)
    mi = procs.index(me)
    got: Dict[int, np.ndarray] = {}
    for s in range(1, P):
        dst = procs[(mi + s) % P]
        src = procs[(mi - s) % P]
        r = _round(x, {dst: [payload_for[dst]]}, {src: 1})
        got[src] = np.asarray(r[src][0])
    return got


def alltoall_bruck(x, procs: List[int], me: int,
                   mine: List[np.ndarray],
                   pair_counts) -> List[Optional[np.ndarray]]:
    """Bruck alltoall: ceil(log2 P) rounds of store-and-forward, one
    packed payload each. ``mine[j]`` is my flat block destined to
    position j; ``pair_counts[o][j]`` the flat length of the (origin
    o, destination j) block — every process computes the identical
    slot plan from it, so payloads need no framing. Returns received
    flat blocks by SOURCE position (my own position is None: the local
    block never leaves the process)."""
    P = len(procs)
    mi = procs.index(me)
    dtype = np.asarray(mine[(mi + 1) % P] if P > 1 else mine[mi]).dtype
    # slot t holds the block whose (dest - origin) displacement is t;
    # before round k (distance d=2^k) the slot's content at process p
    # originated at p - (t & (d-1)) — both sides derive sizes from that
    slot: Dict[int, np.ndarray] = {
        t: _flat(mine[(mi + t) % P]) for t in range(1, P)
    }
    d = 1
    while d < P:
        ts = [t for t in range(1, P) if t & d]
        dst = procs[(mi + d) % P]
        src = procs[(mi - d) % P]
        payload = _concat([slot[t] for t in ts], dtype)
        got = _flat(_round(x, {dst: [payload]}, {src: 1})[src][0])
        off = 0
        for t in ts:
            o = (mi - d - (t & (d - 1))) % P
            j = (o + t) % P
            c = int(pair_counts[o][j])
            slot[t] = got[off:off + c]
            off += c
        if off != got.shape[0]:
            raise MPIError(
                ErrorCode.ERR_TRUNCATE,
                f"bruck alltoall round d={d}: payload from process "
                f"{src} has {got.shape[0]} elements, the shared count "
                f"plan implies {off} — mismatched counts across "
                "processes?",
            )
        d <<= 1
    out: List[Optional[np.ndarray]] = [None] * P
    for t in range(1, P):
        out[(mi - t) % P] = slot[t]
    return out
