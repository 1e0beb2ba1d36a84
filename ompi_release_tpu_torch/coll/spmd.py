"""Collective algorithm bodies over rank-stacked tensors — the data plane.

Counterpart of ``ompi_release_tpu/coll/spmd.py``. There each algorithm
is a per-rank body run under ``shard_map`` that talks to its peers with
``lax.ppermute``; here each is ONE function over the whole ``(n, ...)``
tensor whose row r is rank r's buffer:

- ``lax.axis_index`` becomes the static rank list ``range(n)`` (per-rank
  masks and indices are computed on the host and cached on the device);
- ``lax.ppermute(x, perm)`` becomes :func:`ppermute`, a gather along
  dim 0 — ranks that receive nothing get ZEROS, as ppermute gives them
  (the recursive-doubling fold/unfold relies on it);
- a per-rank ``jnp.take(chunks, idx, 0)`` becomes ``chunks[arange(n),
  idx]`` and ``jnp.where(rank_cond, a, b)`` a row-masked ``where``;
- ``lax.scan`` becomes a Python loop; the segmented ring's ``lax.map``
  over independent segments becomes a batch dimension (same bits,
  ~nseg x fewer launches).

Every combine goes through the ``Op`` the caller passes — the resolved
op, so large f32/bf16 SUMs run the CUDA streaming kernel — except in the
ring allreduce of a SUM on the card (:func:`ring_on_kernel`), whose two
passes run as one ``ring_fold`` kernel (``ops/cuda_op.py``) with no
per-round gathers or combines. Every algorithm keeps the reference's
per-element reduction order, that kernel included, so the results are
bitwise-identical to the JAX package's. Inputs are never written:
bodies that update in place do so on their own copies.
"""

from __future__ import annotations

import functools
import threading
from typing import List, Sequence, Tuple

import torch

from ..ops import cuda_op
from ..ops.op import Op


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

#: a CUDA-graph capture in progress on this thread (``coll/plan.py``):
#: ``holds`` collects every cached index tensor the captured body reads,
#: so the frozen graph keeps them alive past an eviction
_graph_tls = threading.local()


def hold_indices(holds) -> None:
    """Arm (a list) or disarm (None) this thread's capture: while armed,
    every cached index tensor a body reads is appended to ``holds``, and
    a cache miss raises instead of copying host indices to the device
    inside the capture."""
    _graph_tls.holds = holds


@functools.lru_cache(maxsize=4096)
def _build(values: Tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    if getattr(_graph_tls, "holds", None) is not None:
        # never cached (lru_cache keeps no exceptions): the capture
        # fails and its plan stays interpreted
        raise RuntimeError("index cache miss inside a CUDA-graph capture")
    # a normal tensor even when first asked for under inference_mode: a
    # cached index may later be saved for an autograd backward
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _cached(values: Tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    t = _build(values, dtype, device)
    holds = getattr(_graph_tls, "holds", None)
    if holds is not None:
        holds.append(t)
    return t


def _idx(values: Sequence, device: torch.device) -> torch.Tensor:
    """Host-computed per-rank indices as a cached device tensor."""
    return _cached(_freeze(values), torch.int64, str(device))


def _freeze(values) -> Tuple:
    return tuple(_freeze(v) if isinstance(v, (list, tuple)) else v
                 for v in values)


def _ranks(n: int, device: torch.device) -> torch.Tensor:
    return _idx(range(n), device)


def _row_mask(cond: Sequence[bool], like: torch.Tensor) -> torch.Tensor:
    m = _cached(tuple(bool(c) for c in cond), torch.bool, str(like.device))
    return m.view((len(cond),) + (1,) * (like.dim() - 1))


def _where(cond: Sequence[bool], a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """``jnp.where(rank_cond, a, b)``: row r from ``a`` where cond[r]."""
    return torch.where(_row_mask(cond, a), a, b)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``lax.ppermute`` over the leading rank axis: row ``src`` goes to
    row ``dst`` for each pair; rows that receive nothing are zeros."""
    n = x.shape[0]
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    if sorted(dst) == list(range(n)):
        inv = [0] * n
        for s, d in perm:
            inv[d] = s
        return x.index_select(0, _idx(inv, x.device))
    out = torch.zeros_like(x)
    if perm:
        out.index_copy_(0, _idx(dst, x.device),
                        x.index_select(0, _idx(src, x.device)))
    return out


def _take(x: torch.Tensor, idx) -> torch.Tensor:
    """Per-rank ``jnp.take(x_r, idx[r], 0)``: ``x[r, idx[r]]`` for all r.
    ``idx`` is a host list or a device tensor of length n."""
    n = x.shape[0]
    if not isinstance(idx, torch.Tensor):
        idx = _idx(idx, x.device)
    return x[_ranks(n, x.device), idx]


def _put(x: torch.Tensor, idx, val: torch.Tensor) -> None:
    """In place: ``x[r, idx[r]] = val[r]`` for all r."""
    n = x.shape[0]
    if not isinstance(idx, torch.Tensor):
        idx = _idx(idx, x.device)
    x[_ranks(n, x.device), idx] = val


def _ring_perm(n: int) -> List[Tuple[int, int]]:
    return [(i, (i + 1) % n) for i in range(n)]


def _pad_to(flat: torch.Tensor, total: int, fill) -> torch.Tensor:
    """(n, L) -> a NEW (n, total) tensor, tail filled with ``fill``."""
    pad = total - flat.shape[1]
    if pad == 0:
        return flat.clone()
    tail = torch.full((flat.shape[0], pad), fill, dtype=flat.dtype,
                      device=flat.device)
    return torch.cat([flat, tail], dim=1)


def _bcast_rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """One result, materialized as every rank's own row."""
    return v.unsqueeze(0).expand((n,) + tuple(v.shape)).contiguous()


# ---------------------------------------------------------------------------
# allreduce family
# ---------------------------------------------------------------------------

def fold_ranks(g: torch.Tensor, op: Op) -> torch.Tensor:
    """The fused component's ``psum``: a fold over the leading axis in
    one FIXED order — a pairwise tree, rows (0,1), (2,3), ... combined
    per round with an odd last row passed through (the order of the
    reference's ``_tree_reduce_axis0``). ``tensor.sum(0)`` is never
    used: its order is unspecified."""
    n = g.shape[0]
    while n > 1:
        half = n // 2
        merged = op(g[0:2 * half:2], g[1:2 * half:2])
        if n % 2:
            merged = torch.cat([merged, g[2 * half:n]], dim=0)
        g = merged
        n = g.shape[0]
    return g[0]


def allreduce_lax(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Allreduce of the fused component: :func:`fold_ranks`, result on
    every rank."""
    return _bcast_rows(fold_ranks(x, op), x.shape[0])


def allreduce_pair_lax(vals: torch.Tensor, idxs: torch.Tensor,
                       op: Op) -> Tuple[torch.Tensor, torch.Tensor]:
    """MINLOC/MAXLOC allreduce over (value, index) tensors, rank order."""
    n = vals.shape[0]
    accv, acci = vals[0], idxs[0]
    for i in range(1, n):
        accv, acci = op((accv, acci), (vals[i], idxs[i]))
    return _bcast_rows(accv, n), _bcast_rows(acci, n)


def allreduce_recursive_doubling(x: torch.Tensor, op: Op,
                                 n: int) -> torch.Tensor:
    """Recursive doubling (coll_tuned_allreduce.c:144), any n, with the
    standard fold/unfold for non-power-of-two n."""
    shape = x.shape
    xf = x.reshape(n, -1)
    ranks = range(n)

    def combine(mine, theirs, their_rank_is_lower: List[bool]):
        # non-commutative ops need the lower-rank operand on the left
        if op.commutative:
            return op(mine, theirs)
        return _where(their_rank_is_lower, op(theirs, mine),
                      op(mine, theirs))

    p2 = 1 << (n.bit_length() - 1)
    if p2 == n:
        d = 1
        while d < n:
            recv = ppermute(xf, [(i, i ^ d) for i in ranks])
            xf = combine(xf, recv, [(r & d) != 0 for r in ranks])
            d *= 2
        return xf.reshape(shape)

    rem = n - p2
    # fold: even rank r < 2*rem sends to r+1 (sender is the lower rank)
    recv = ppermute(xf, [(2 * i, 2 * i + 1) for i in range(rem)])
    is_odd_low = [r < 2 * rem and r % 2 == 1 for r in ranks]
    xf = _where(is_odd_low, combine(xf, recv, [True] * n), xf)

    def eff(r: int) -> int:  # doubling-phase rank (-1 = idle)
        if r < 2 * rem:
            return r // 2 if r % 2 == 1 else -1
        return r - rem

    def actual(e: int) -> int:
        return 2 * e + 1 if e < rem else e + rem

    participating = [r >= 2 * rem or r % 2 == 1 for r in ranks]
    my_eff = [r // 2 if r < 2 * rem else r - rem for r in ranks]
    d = 1
    while d < p2:
        perm = [(r, actual(eff(r) ^ d)) for r in ranks if eff(r) >= 0]
        recv = ppermute(xf, perm)
        xf = _where(participating,
                    combine(xf, recv, [(e & d) != 0 for e in my_eff]), xf)
        d *= 2

    # unfold: odd rank r < 2*rem sends the result to r-1
    recv = ppermute(xf, [(2 * i + 1, 2 * i) for i in range(rem)])
    is_even_low = [r < 2 * rem and r % 2 == 0 for r in ranks]
    xf = _where(is_even_low, recv, xf)
    return xf.reshape(shape)


def ring_on_kernel(x: torch.Tensor, op: Op) -> bool:
    """Whether a ring allreduce of ``x`` under ``op`` runs as one
    ``ring_fold`` kernel rather than the interpreted :func:`_ring_passes`:
    a CUDA tensor, and the op layer's claim (``cuda_op.claims_ring``:
    SUM by object in f32 or bf16, the CUDA op component not excluded).
    The CPU keeps the interpreted passes."""
    return x.is_cuda and cuda_op.claims_ring(op, x.dtype)


def _ring_fold(x: torch.Tensor, n: int, seg: int) -> torch.Tensor:
    """The ring's two passes as one kernel, chunk index ``(p % seg) //
    ceil(seg / n)`` at position ``p`` of a rank's buffer."""
    return cuda_op.ring_fold(x.contiguous(), n, seg, -(-seg // n))


def _ring_passes(chunks: torch.Tensor, op: Op, n: int) -> torch.Tensor:
    """The two ring passes (reduce-scatter + allgather) over a chunked
    ``(n ranks, n chunks, *rest)`` buffer, updated in place. A chunk's
    accumulation order is fixed by its chunk index alone, whatever
    ``rest`` holds — which is what lets the pipelined and segmented
    wrappers run segments as extra dimensions."""
    perm = _ring_perm(n)
    for k in range(n - 1):
        send = _take(chunks, [(r - k) % n for r in range(n)])
        recv = ppermute(send, perm)
        recv_idx = [(r - k - 1) % n for r in range(n)]
        _put(chunks, recv_idx, op(_take(chunks, recv_idx), recv))
    for k in range(n - 1):
        send = _take(chunks, [(r - k + 1) % n for r in range(n)])
        recv = ppermute(send, perm)
        _put(chunks, [(r - k) % n for r in range(n)], recv)
    return chunks


def allreduce_ring(x: torch.Tensor, op: Op, n: int) -> torch.Tensor:
    """Ring allreduce: reduce-scatter pass + allgather pass
    (coll_tuned_allreduce.c:361)."""
    if n == 1:
        return x.clone()
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    if ring_on_kernel(x, op):
        return _ring_fold(x, n, max(total, 1))
    chunk = -(-total // n)
    ident = op.identity_for(x.dtype)
    chunks = _pad_to(flat, chunk * n, ident).reshape(n, n, chunk)
    chunks = _ring_passes(chunks, op, n)
    return chunks.reshape(n, -1)[:, :total].reshape(x.shape)


def allreduce_segmented_ring(x: torch.Tensor, op: Op, n: int,
                             segsize_elems: int) -> torch.Tensor:
    """Segmented ring (coll_tuned_allreduce.c:636): each ~1 MiB segment
    is ring-reduced independently (its chunk index — hence each
    element's order — comes from the position WITHIN its segment). The
    segments are independent, so they run batched as one extra
    dimension: the same bits as one ring per segment."""
    if n == 1:
        return x.clone()
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    seg = max(segsize_elems, n)
    nseg = -(-total // seg)
    if nseg <= 1:
        return allreduce_ring(x, op, n)
    if ring_on_kernel(x, op):
        return _ring_fold(x, n, seg)
    ident = op.identity_for(x.dtype)
    chunk = -(-seg // n)
    segs = _pad_to(flat, nseg * seg, ident).reshape(n * nseg, seg)
    segs = _pad_to(segs, chunk * n, ident).reshape(n, nseg, n, chunk)
    chunks = segs.permute(0, 2, 1, 3).contiguous()  # (rank, chunk, seg, c)
    chunks = _ring_passes(chunks, op, n)
    out = chunks.permute(0, 2, 1, 3).reshape(n, nseg, n * chunk)[:, :, :seg]
    return out.reshape(n, nseg * seg)[:, :total].reshape(x.shape)


def allreduce_basic_linear(x: torch.Tensor, op: Op, n: int) -> torch.Tensor:
    """Linear algorithm (coll/basic): sequential reduce in rank order —
    the canonical order."""
    acc = x[0]
    for i in range(1, n):
        acc = op(acc, x[i])
    return _bcast_rows(acc, n)


def allreduce_nonoverlapping(x: torch.Tensor, op: Op, n: int,
                             root: int = 0) -> torch.Tensor:
    """Reduce-to-root then bcast (tuned's nonoverlapping)."""
    return bcast_binomial(reduce_binomial(x, op, n, root), n, root)


# ---------------------------------------------------------------------------
# bcast / reduce
# ---------------------------------------------------------------------------

def bcast_binomial(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Binomial-tree broadcast (coll_tuned_bcast.c): ceil(log2 n) rounds."""
    if n == 1:
        return x.clone()
    rank_of = lambda v: (v + root) % n  # noqa: E731
    v = [(r - root) % n for r in range(n)]
    for k in range((n - 1).bit_length()):
        d = 1 << k
        perm = [(rank_of(vs), rank_of(vs + d)) for vs in range(min(d, n - d))]
        recv = ppermute(x, perm)
        x = _where([d <= vr < 2 * d for vr in v], recv, x)
    return x


def bcast_binary_tree(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Balanced-binary-tree broadcast (``bcast_intra_bintree``): per heap
    level, one exchange for left children and one for right children."""
    if n == 1:
        return x.clone()
    rank_of = lambda vv: (vv + root) % n  # noqa: E731
    v = [(r - root) % n for r in range(n)]
    for lvl in range(n.bit_length()):
        for side in (1, 2):  # left child 2v+1, right child 2v+2
            perm = [
                (rank_of(vs), rank_of(2 * vs + side))
                for vs in range(n)
                if (vs + 1).bit_length() - 1 == lvl and 2 * vs + side < n
            ]
            if not perm:
                continue
            recv = ppermute(x, perm)
            recv_mask = [
                (vr % 2 == 1 if side == 1 else (vr % 2 == 0 and vr > 0))
                and (1 << (lvl + 1)) <= vr + 1 < (1 << (lvl + 2))
                for vr in v
            ]
            x = _where(recv_mask, recv, x)
    return x


def bcast_chain(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Chain broadcast (fanout 1): n-1 hops rank to rank."""
    if n == 1:
        return x.clone()
    rank_of = lambda v: (v + root) % n  # noqa: E731
    v = [(r - root) % n for r in range(n)]
    for hop in range(n - 1):
        recv = ppermute(x, [(rank_of(hop), rank_of(hop + 1))])
        x = _where([vr == hop + 1 for vr in v], recv, x)
    return x


def bcast_pipeline(x: torch.Tensor, n: int, root: int,
                   seg_elems: int) -> torch.Tensor:
    """Pipelined (segmented chain) broadcast (``bcast_intra_pipeline``):
    S segments stream down the rank chain, one hop per tick, S + n - 2
    ticks; segment s reaches vrank v at tick s + v."""
    if n == 1:
        return x.clone()
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    seg = max(1, seg_elems)
    S = max(1, -(-total // seg))
    segs = _pad_to(flat, S * seg, 0).reshape(n, S, seg)
    v = _idx([(r - root) % n for r in range(n)], x.device)
    perm = [((i + root) % n, (i + 1 + root) % n) for i in range(n - 1)]
    for t in range(S + n - 2):
        # rank v sends segment t - v; receiver v stores segment t-(v-1)
        sidx = (t - v).clamp(0, S - 1)
        recv = ppermute(_take(segs, sidx), perm)
        rpos = t - (v - 1)
        ridx = rpos.clamp(0, S - 1)
        valid = ((rpos >= 0) & (rpos < S) & (v > 0)).view(n, 1)
        _put(segs, ridx, torch.where(valid, recv, _take(segs, ridx)))
    return segs.reshape(n, -1)[:, :total].reshape(x.shape)


def bcast_masked_psum(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """One-collective bcast: zero every non-root contribution and fold
    (:func:`fold_ranks`). Exact, except -0.0 becomes +0.0 (adding
    zeros), as in the reference; bool folds as max."""
    n = x.shape[0]
    contrib = _where([r == root for r in range(n)], x, torch.zeros_like(x))
    if x.dtype is torch.bool:
        red = fold_ranks(contrib.to(torch.int32),
                         Op("max", torch.maximum)).to(torch.bool)
    else:
        red = fold_ranks(contrib, Op("sum", lambda a, b: a + b))
    return _bcast_rows(red, n)


def reduce_binomial(x: torch.Tensor, op: Op, n: int,
                    root: int = 0) -> torch.Tensor:
    """Binomial-tree reduce toward root; non-root ranks end with
    partial values (MPI leaves their recv buffers undefined)."""
    if n == 1:
        return x.clone()
    rank_of = lambda v: (v + root) % n  # noqa: E731
    v = [(r - root) % n for r in range(n)]
    for k in range((n - 1).bit_length()):
        d = 1 << k
        perm = [(rank_of(vs), rank_of(vs - d)) for vs in range(d, n, 2 * d)]
        recv = ppermute(x, perm)
        x = _where([vr % (2 * d) == 0 and vr + d < n for vr in v],
                   op(x, recv), x)
    return x


def _root_only(x: torch.Tensor, root: int) -> torch.Tensor:
    n = x.shape[0]
    return _where([r == root for r in range(n)], x, torch.zeros_like(x))


def reduce_in_order_binary(x: torch.Tensor, op: Op, n: int,
                           root: int = 0) -> torch.Tensor:
    """In-order binary-tree reduce (``reduce_intra_in_order_binary``):
    reduce_binomial at root 0 merges contiguous true-rank ranges in
    order; the result then takes one hop to a non-zero root."""
    if n == 1:
        return x.clone()
    x = reduce_binomial(x, op, n, root=0)
    if root != 0:
        moved = ppermute(x, [(0, root)])
        x = _where([r == root for r in range(n)], moved, x)
    return _root_only(x, root)


def reduce_linear(x: torch.Tensor, op: Op, n: int,
                  root: int = 0) -> torch.Tensor:
    """Linear reduce: the rank-order left fold, kept at root only."""
    return _root_only(allreduce_basic_linear(x, op, n), root)


# ---------------------------------------------------------------------------
# allgather: every body returns (n ranks, n blocks, *block)
# ---------------------------------------------------------------------------

def allgather_lax(x: torch.Tensor) -> torch.Tensor:
    return _bcast_rows(x, x.shape[0])


def allgather_bruck(x: torch.Tensor, n: int) -> torch.Tensor:
    """Bruck allgather (``allgather_intra_bruck``): ceil(log2 n) rounds
    for any n, then a final rotation. Local position i holds block
    (rank + i) mod n throughout."""
    out = torch.zeros((n, n) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:, 0] = x
    cnt = 1
    while cnt < n:
        send_cnt = min(cnt, n - cnt)
        recv = ppermute(out[:, :send_cnt].contiguous(),
                        [(i, (i - cnt) % n) for i in range(n)])
        out[:, cnt:cnt + send_cnt] = recv
        cnt += send_cnt
    rot = _idx([[(j - r) % n for j in range(n)] for r in range(n)], x.device)
    return out[_ranks(n, x.device).view(n, 1), rot]


def allgather_recursive_doubling(x: torch.Tensor, n: int) -> torch.Tensor:
    """Recursive-doubling allgather (power-of-two n only, like the
    reference): after round k every rank holds its 2^(k+1)-aligned
    group's blocks at their natural indices."""
    if n & (n - 1):
        raise ValueError(f"recursive-doubling allgather needs "
                         f"power-of-two ranks, got {n}")
    out = torch.zeros((n, n) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _put(out, list(range(n)), x)
    rows = _ranks(n, x.device).view(n, 1)
    k = 1
    while k < n:
        base = [(r // k) * k for r in range(n)]
        mine = out[rows, _idx([[b + j for j in range(k)] for b in base],
                              x.device)]
        recv = ppermute(mine, [(i, i ^ k) for i in range(n)])
        out[rows, _idx([[(b ^ k) + j for j in range(k)] for b in base],
                       x.device)] = recv
        k *= 2
    return out


def allgather_ring(x: torch.Tensor, n: int) -> torch.Tensor:
    """Neighbor-exchange ring allgather (coll_tuned_allgather.c ring)."""
    out = torch.zeros((n, n) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _put(out, list(range(n)), x)
    perm = _ring_perm(n)
    cur = x
    for k in range(n - 1):
        cur = ppermute(cur, perm)
        _put(out, [(r - k - 1) % n for r in range(n)], cur)
    return out


# ---------------------------------------------------------------------------
# reduce_scatter_block: x is (n, n*chunk, ...); rank i gets reduced chunk i
# ---------------------------------------------------------------------------

def reduce_scatter_lax(x: torch.Tensor, op: Op, n: int) -> torch.Tensor:
    """The fused component's reduce_scatter: :func:`fold_ranks` over the
    blocked buffers, rank i keeps chunk i."""
    blocks = x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:]))
    out = fold_ranks(blocks, op)
    return out.clone() if n == 1 else out.contiguous()


def reduce_scatter_ring(x: torch.Tensor, op: Op, n: int) -> torch.Tensor:
    """Ring reduce-scatter (the first phase of ring allreduce), indices
    chosen so chunk c completes exactly at rank c."""
    if n == 1:
        return x.clone()
    chunks = x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:])).clone()
    perm = _ring_perm(n)
    for k in range(n - 1):
        send = _take(chunks, [(r - k - 1) % n for r in range(n)])
        recv = ppermute(send, perm)
        recv_idx = [(r - k - 2) % n for r in range(n)]
        _put(chunks, recv_idx, op(_take(chunks, recv_idx), recv))
    return _take(chunks, list(range(n)))


# ---------------------------------------------------------------------------
# alltoall: blocks is (n, n, ...); out[r, j] = what rank j sent rank r
# ---------------------------------------------------------------------------

def alltoall_lax(blocks: torch.Tensor, n: int) -> torch.Tensor:
    return blocks.transpose(0, 1).contiguous()


def alltoall_bruck(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """Bruck alltoall (``alltoall_intra_bruck``): log2(n) store-and-
    forward phases; position j at rank r holds a block destined to
    rank r + j, and phase k moves every position with bit k set forward
    by k ranks."""
    rows = _ranks(n, blocks.device).view(n, 1)
    local = blocks[rows, _idx([[(r + j) % n for j in range(n)]
                               for r in range(n)], blocks.device)]
    k = 1
    while k < n:
        sel = _idx([j for j in range(n) if j & k], blocks.device)
        recv = ppermute(local[:, sel], [(i, (i + k) % n) for i in range(n)])
        local[:, sel] = recv
        k *= 2
    return local[rows, _idx([[(r - j) % n for j in range(n)]
                             for r in range(n)], blocks.device)]


def alltoall_pairwise(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """Pairwise-exchange alltoall: n-1 rounds; round k sends the block
    for rank+k and receives from rank-k."""
    out = torch.zeros_like(blocks)
    own = list(range(n))
    _put(out, own, _take(blocks, own))
    for k in range(1, n):
        send = _take(blocks, [(r + k) % n for r in range(n)])
        recv = ppermute(send, [(i, (i + k) % n) for i in range(n)])
        _put(out, [(r - k) % n for r in range(n)], recv)
    return out


# ---------------------------------------------------------------------------
# gather / scatter: the root's buffer holds the n blocks in rank order
# ---------------------------------------------------------------------------

def gather_linear(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Linear gather (``coll_tuned_gather.c`` basic_linear; also the
    fused and basic components' body): one allgather, root keeps it
    (other ranks' buffers are undefined in MPI: zeros here, as in the
    reference)."""
    g = x.reshape((1, -1) + tuple(x.shape[2:])).expand(
        (n, -1) + tuple(x.shape[2:]))
    return _where([r == root for r in range(n)], g, torch.zeros_like(g))


def scatter_linear(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Linear scatter (basic_linear; also the fused and basic
    components' body): bcast root's buffer (:func:`bcast_masked_psum`),
    each rank takes its own chunk."""
    full = bcast_masked_psum(x, root)
    chunks = full.reshape((n, n, -1) + tuple(full.shape[2:]))
    return _take(chunks, list(range(n)))


def _window_index(base: Sequence[int], k: int,
                  device: torch.device) -> torch.Tensor:
    """Per-rank block indices ``base[r] + j`` for j < k: an (n, k)
    device tensor (the reference's ``dynamic_slice_in_dim`` window)."""
    return _idx([[b + j for j in range(k)] for b in base], device)


def _masked(cond: Sequence[Sequence[bool]], t: torch.Tensor) -> torch.Tensor:
    """``jnp.where(mask, t, 0)`` with a host-computed (n, k) mask over
    the first two dims of ``t``."""
    m = _cached(_freeze([[bool(c) for c in row] for row in cond]),
                torch.bool, str(t.device))
    m = m.view(tuple(m.shape) + (1,) * (t.dim() - 2))
    return torch.where(m, t, torch.zeros_like(t))


def gather_binomial(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Binomial-tree gather (``gather_intra_binomial``): log2(n) rounds;
    at round k the ranks whose root-relative vrank has lowest set bit k
    forward their accumulated k-block range to vrank - k. Each round
    moves a k-block window at a clamped base; window entries outside
    the sender's own range are masked to zero and receivers merge
    additively (``cur + recv``) into the same window, exactly as the
    reference does (so a received -0.0 lands as +0.0 there and here).
    Non-root ranks end with zeros. Returns (n, n*block, ...)."""
    rows = _ranks(n, x.device).view(n, 1)
    v = [(r - root) % n for r in range(n)]
    out = torch.zeros((n, n) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _put(out, v, x)
    rank_of = lambda vv: (vv + root) % n  # noqa: E731
    k = 1
    while k < n:
        s_send = [min(vr, n - k) for vr in v]
        window = out[rows, _window_index(s_send, k, x.device)]
        live = [[(vr & (2 * k - 1)) == k and s + j >= vr for j in range(k)]
                for vr, s in zip(v, s_send)]
        contrib = _masked(live, window)
        perm = [(rank_of(vs), rank_of(vs - k))
                for vs in range(n) if (vs & (2 * k - 1)) == k]
        recv = ppermute(contrib, perm)
        recv_idx = _window_index([min(vr + k, n - k) for vr in v], k,
                                 x.device)
        out[rows, recv_idx] = out[rows, recv_idx] + recv
        k *= 2
    # vrank order -> rank order: result[i] = out[(i - root) % n]
    out = torch.roll(out, shifts=root, dims=1)
    flat = out.reshape((n, -1) + tuple(x.shape[2:]))
    return _where([r == root for r in range(n)], flat, torch.zeros_like(flat))


def scatter_binomial(x: torch.Tensor, n: int, root: int = 0) -> torch.Tensor:
    """Binomial-tree scatter (``scatter_intra_binomial``): the mirror of
    :func:`gather_binomial` — root starts with all n blocks; at round k
    (descending) every range holder passes the upper k blocks of its
    range to vrank + k (a masked k-block window, additive merge).
    ``x`` is (n, n*block, ...) with root's row holding the blocks;
    returns each rank's own block, (n, block, ...)."""
    rows = _ranks(n, x.device).view(n, 1)
    v = [(r - root) % n for r in range(n)]
    blocks = x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:]))
    buf = _where([r == root for r in range(n)],
                 torch.roll(blocks, shifts=-root, dims=1),
                 torch.zeros_like(blocks))
    rank_of = lambda vv: (vv + root) % n  # noqa: E731
    k = 1 << max(0, (n - 1).bit_length() - 1)
    while k >= 1:
        s_send = [min(vr + k, n - k) for vr in v]
        window = buf[rows, _window_index(s_send, k, x.device)]
        live = [[vr % (2 * k) == 0 and vr + k < n and s + j >= vr + k
                 for j in range(k)] for vr, s in zip(v, s_send)]
        contrib = _masked(live, window)
        perm = [(rank_of(vs), rank_of(vs + k))
                for vs in range(n) if vs % (2 * k) == 0 and vs + k < n]
        recv = ppermute(contrib, perm)
        recv_idx = _window_index([min(vr, n - k) for vr in v], k, x.device)
        buf[rows, recv_idx] = buf[rows, recv_idx] + recv
        k //= 2
    return _take(buf, v)


# ---------------------------------------------------------------------------
# scan / barrier
# ---------------------------------------------------------------------------

def associative_scan(g: torch.Tensor, op: Op) -> torch.Tensor:
    """Inclusive scan over the leading axis in the combine order of
    ``jax.lax.associative_scan`` (combine adjacent pairs, scan the
    reduced sequence recursively, fill in the even positions,
    interleave): the fused component's scan, one fixed order. ``op``
    gets ``(earlier, later)``; ``g`` may be a tuple of tensors for a
    pair op."""
    pair = isinstance(g, tuple)
    elems = g if pair else (g,)
    comb = (lambda a, b: op(a, b)) if pair else \
        (lambda a, b: (op(a[0], b[0]),))

    def scan(el):
        m = el[0].shape[0]
        if m < 2:
            return el
        reduced = comb(tuple(e[0:m - 1:2] for e in el),
                       tuple(e[1::2] for e in el))
        odd = scan(reduced)
        if m % 2 == 0:
            even = comb(tuple(o[:-1] for o in odd),
                        tuple(e[2::2] for e in el))
        else:
            even = comb(odd, tuple(e[2::2] for e in el))
        even = tuple(torch.cat([e[0:1], r], dim=0)
                     for e, r in zip(el, even))
        out = []
        for ev, od in zip(even, odd):
            res = torch.empty((m,) + tuple(ev.shape[1:]), dtype=ev.dtype,
                              device=ev.device)
            res[0::2] = ev
            res[1::2] = od
            out.append(res)
        return tuple(out)

    res = scan(elems)
    return res if pair else res[0]


def scan_gather(x, op: Op, exclusive: bool = False):
    """The fused component's scan: every rank's buffer gathered, one
    :func:`associative_scan`, rank r keeps prefix r (exscan: prefix
    r - 1, zeros at rank 0, which MPI leaves undefined). ``x`` is a
    tensor or a pair-op (values, indices) tuple."""
    s = associative_scan(x, op)
    if not exclusive:
        return s if isinstance(s, tuple) else s.clone()

    def shift(t):
        return torch.cat([torch.zeros_like(t[0:1]), t[:-1]], dim=0)

    return tuple(shift(t) for t in s) if isinstance(s, tuple) else shift(s)


def scan_recursive_doubling(x: torch.Tensor, op: Op, n: int,
                            exclusive: bool = False) -> torch.Tensor:
    """Inclusive/exclusive prefix reduction over ranks (MPI_Scan/Exscan),
    log2-round recursive doubling (libnbc's iscan schedule): each round
    folds ``op(recv, acc)``, the lower ranks' partial on the left."""
    ranks = range(n)
    acc = x
    d = 1
    while d < n:
        recv = ppermute(acc, [(i, i + d) for i in range(n - d)])
        acc = _where([r >= d for r in ranks], op(recv, acc), acc)
        d *= 2
    if not exclusive:
        return acc if acc is not x else x.clone()
    # exscan: shift inclusive results up by one rank; rank 0 -> zeros
    return ppermute(acc, [(i, i + 1) for i in range(n - 1)])


def barrier_psum(x: torch.Tensor) -> torch.Tensor:
    """Barrier = 0-byte allreduce of the rank axis's zeros; completion
    of the queued work is the synchronization."""
    return _bcast_rows(fold_ranks(torch.zeros_like(x),
                                  Op("sum", lambda a, b: a + b)), x.shape[0])


# ---------------------------------------------------------------------------
# two-level (ml) bodies: rank r = (node r // intra, local r % intra)
# ---------------------------------------------------------------------------

def allreduce_two_level(x: torch.Tensor, op: Op, inter: int,
                        intra: int) -> torch.Tensor:
    """Hierarchical allreduce (coll/ml + bcol + sbgp analogue): ring
    reduce-scatter inside each fast domain (``intra`` consecutive
    ranks), the owned chunks reduced across the slow domain (one
    :func:`fold_ranks` over nodes), then an allgather inside the
    domain. Inter-domain traffic is 1/intra of the payload."""
    n = inter * intra
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    chunk = -(-total // intra)
    padded = _pad_to(flat, chunk * intra, op.identity_for(x.dtype))
    # level 1: reduce-scatter within each node -> (inter, intra, chunk)
    mine = torch.stack([
        reduce_scatter_ring(padded[i * intra:(i + 1) * intra], op, intra)
        for i in range(inter)])
    # level 2: allreduce each local position's chunk across the nodes
    red = fold_ranks(mine, op)  # (intra, chunk)
    # level 3: allgather within the node: every rank the whole vector
    return _bcast_rows(red.reshape(-1)[:total], n).reshape(x.shape)


def bcast_two_level(x: torch.Tensor, inter: int, intra: int,
                    root: int) -> torch.Tensor:
    """Hierarchical bcast: root's value, zeros elsewhere, folded inside
    each fast domain and then across domains (the reference's
    ``psum(psum(contrib, local), node)``)."""
    n = inter * intra
    contrib = _where([r == root for r in range(n)], x, torch.zeros_like(x))
    add = Op("sum", lambda a, b: a + b)
    if x.dtype is torch.bool:
        contrib = contrib.to(torch.int32)
        add = Op("max", torch.maximum)
    per_node = contrib.reshape((inter, intra) + tuple(x.shape[1:]))
    local = fold_ranks(per_node.transpose(0, 1), add)  # (inter, ...)
    return _bcast_rows(fold_ranks(local, add).to(x.dtype), n)


def reduce_two_level(x: torch.Tensor, op: Op, inter: int, intra: int,
                     root: int) -> torch.Tensor:
    """Hierarchical rooted reduce: the two-level allreduce kept at the
    root's position."""
    return _root_only(allreduce_two_level(x, op, inter, intra), root)


def allgather_two_level(x: torch.Tensor, inter: int,
                        intra: int) -> torch.Tensor:
    """Hierarchical allgather: each node's blocks gathered inside the
    fast domain, then the per-node aggregates exchanged across domains.
    Returns (n ranks, n blocks, ...) in rank order (node-major)."""
    # on one device both levels land every rank's block in rank order
    return _bcast_rows(x, inter * intra)


def reduce_scatter_two_level(x: torch.Tensor, op: Op, inter: int,
                             intra: int) -> torch.Tensor:
    """Hierarchical reduce_scatter_block: the two-level allreduce, each
    rank keeping its own chunk."""
    n = inter * intra
    red = allreduce_two_level(x, op, inter, intra)
    chunks = red.reshape((n, n, -1) + tuple(red.shape[2:]))
    return _take(chunks, list(range(n)))


def alltoall_two_level(blocks: torch.Tensor, inter: int,
                       intra: int) -> torch.Tensor:
    """Hierarchical alltoall: an inter-domain exchange of whole-domain
    super-blocks, then an intra-domain exchange (each slow-domain
    message aggregates intra**2 rank-pair blocks). ``blocks``: (n, n,
    ...), row r's block j destined to rank j; returns out[r, j] = the
    block rank j sent to rank r."""
    rest = tuple(blocks.shape[2:])
    # [src node, src local, dst node, dst local]
    b = blocks.reshape((inter, intra, inter, intra) + rest)
    # inter exchange: rank (dn, sl) receives every node's blocks for
    # its node -> [dn, sl, sn, dl]
    b = b.permute((2, 1, 0, 3) + tuple(range(4, 4 + len(rest)))).contiguous()
    # intra exchange: rank (dn, dl) receives from each local sl
    # -> [dn, dl, sn, sl]
    b = b.permute((0, 3, 2, 1) + tuple(range(4, 4 + len(rest)))).contiguous()
    return b.reshape(blocks.shape)
