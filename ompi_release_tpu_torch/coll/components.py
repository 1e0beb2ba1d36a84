"""coll components: ``fused`` (one fold per collective), ``tuned`` (named
algorithms + decision rules), ``ml`` (two-level hierarchical),
``basic`` (linear reference), ``self`` (size-1 fast path).

Counterpart of ``ompi_release_tpu/coll/components.py`` with the same
priorities: fused 100 > tuned 50 > ml 40 > basic 10, and ``self``
claims size-1 communicators outright. The v-variants live in
``coll/vcoll.py``; fused and tuned hand them their padded kernels.

Every local reduction step of tuned/basic (and fused) resolves its op
through the op framework (:func:`_resolve_op`), so large f32/bf16 SUMs
run the CUDA streaming kernel as ``sum[cuda]`` — a distinct op object,
hence a distinct program-cache key.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..mca import component as mca_component
from ..mca import var as mca_var
from ..ops.op import Op
from ..utils import output
from ..utils.errors import ErrorCode, MPIError
from . import dynamic_rules, pipeline, spmd
from .base import COLL_FRAMEWORK
from .driver import run_sharded, run_sharded2d

_log = output.stream("coll")


def _per_rank_bytes(x) -> int:
    return int(x[0].numel() * x.element_size())


def _resolve_op(op: Op, x) -> Op:
    """Accelerated-kernel resolution for a local-reduction step (the
    ``ompi/mca/op`` select): the cuda component claims large contiguous
    f32/bf16 SUMs, everything else keeps the plain combiner."""
    from ..ops import op as op_mod

    if op.is_pair_op or not isinstance(x, torch.Tensor):
        return op
    return op_mod.resolve(op, x.dtype, _per_rank_bytes(x))


def _sync(comm) -> None:
    """Barrier completion in driver mode: every rank's work queued on the
    comm's device has finished. The device-wide wait holds the capture
    lock (``coll/plan.py``): it must not overlap a CUDA-graph capture on
    another thread (a spanning window's service thread captures the
    home's epoch plans while app threads run collectives), since it
    would wait on the capturing stream."""
    if comm.device.type == "cuda":
        from .plan import capture_lock

        with capture_lock:
            torch.cuda.synchronize(comm.device)


# ---------------------------------------------------------------------------
# fused component — the counterpart of the reference's ``xla`` component
# ---------------------------------------------------------------------------

class _FusedModule:
    """Each collective as one fold over the rank axis — the counterpart
    of the reference's ``xla`` component, whose collectives are single
    fused XLA ops (``psum``, ``all_gather``, ``psum_scatter``,
    ``all_to_all``). Its reductions use :func:`spmd.fold_ranks`, one
    fixed and documented order (a pairwise tree over ranks), never
    ``tensor.sum(0)``, whose order is unspecified. The order XLA's
    ``psum`` takes is not defined, so fused results agree with the
    reference to rounding, not bitwise."""

    def __init__(self, comm) -> None:
        self.comm = comm

    def fns(self) -> Dict[str, Callable]:
        return {
            "allreduce": self.allreduce,
            "reduce": self.reduce,
            "bcast": self.bcast,
            "allgather": self.allgather,
            "gather": self.gather,
            "scatter": self.scatter,
            "reduce_scatter_block": self.reduce_scatter_block,
            "alltoall": self.alltoall,
            "scan": self.scan,
            "exscan": self.exscan,
            "barrier": self.barrier,
            "alltoallv": self.alltoallv,
            "allgatherv": self.allgatherv,
            "gatherv": self.gatherv,
            "scatterv": self.scatterv,
            "reduce_scatter": self.reduce_scatter,
        }

    def allreduce(self, comm, x, op: Op):
        if op.is_pair_op:
            vals, idxs = x
            return run_sharded(
                comm, ("fused", "allreduce_pair", op),
                lambda v, i: spmd.allreduce_pair_lax(v, i, op),
                vals, extra_arrays=(idxs,),
            )
        op = _resolve_op(op, x)
        return run_sharded(comm, ("fused", "allreduce", op),
                           lambda xb: spmd.allreduce_lax(xb, op), x)

    def reduce(self, comm, x, op: Op, root: int):
        if op.is_pair_op:
            vals, idxs = x

            def pair_body(v, i):
                rv, ri = spmd.allreduce_pair_lax(v, i, op)
                return spmd._root_only(rv, root), spmd._root_only(ri, root)

            return run_sharded(comm, ("fused", "reduce_pair", op, root),
                               pair_body, vals, extra_arrays=(idxs,))
        op = _resolve_op(op, x)
        return run_sharded(
            comm, ("fused", "reduce", op, root),
            lambda xb: spmd._root_only(spmd.allreduce_lax(xb, op), root), x,
        )

    def bcast(self, comm, x, root: int):
        return run_sharded(comm, ("fused", "bcast", root),
                           lambda xb: spmd.bcast_masked_psum(xb, root), x)

    def allgather(self, comm, x):
        return run_sharded(comm, ("fused", "allgather"),
                           lambda xb: _flat_gather(spmd.allgather_lax(xb)), x)

    def gather(self, comm, x, root: int):
        return run_sharded(
            comm, ("fused", "gather", root),
            lambda xb: spmd.gather_linear(xb, comm.size, root), x)

    def scatter(self, comm, x, root: int):
        # x: root's row holds the n chunks back to back
        return run_sharded(
            comm, ("fused", "scatter", root),
            lambda xb: spmd.scatter_linear(xb, comm.size, root), x)

    def reduce_scatter_block(self, comm, x, op: Op):
        n = comm.size
        if op.is_pair_op:
            vals, idxs = x

            def pair_body(v, i):
                rv, ri = spmd.allreduce_pair_lax(v, i, op)
                own = list(range(n))
                return (spmd._take(rv.reshape((n, n, -1) + tuple(
                            rv.shape[2:])), own),
                        spmd._take(ri.reshape((n, n, -1) + tuple(
                            ri.shape[2:])), own))

            return run_sharded(comm, ("fused", "rsb_pair", op), pair_body,
                               vals, extra_arrays=(idxs,))
        op = _resolve_op(op, x)
        return run_sharded(comm, ("fused", "reduce_scatter_block", op),
                           lambda xb: spmd.reduce_scatter_lax(xb, op, n), x)

    def alltoall(self, comm, x):
        n = comm.size

        def body(xb):
            blocks = xb.reshape((n, n, -1) + tuple(xb.shape[2:]))
            return spmd.alltoall_lax(blocks, n).reshape(xb.shape)

        return run_sharded(comm, ("fused", "alltoall"), body, x)

    def scan(self, comm, x, op: Op, *, exclusive: bool = False):
        """Gather-based scan in :func:`spmd.associative_scan`'s order
        (``lax.associative_scan``'s); pair ops scan their (value,
        index) tuples. Past ``coll_xla_scan_gather_limit`` per rank it
        declines, so tuned's recursive doubling takes the call (the
        gather stages the whole comm's buffers)."""
        if op.is_pair_op:
            vals, idxs = x
            return run_sharded(
                comm, ("fused", "scan_pair", op, exclusive),
                lambda v, i: spmd.scan_gather((v, i), op, exclusive),
                vals, extra_arrays=(idxs,))
        if _per_rank_bytes(x) > int(mca_var.get(
                "coll_xla_scan_gather_limit", 1 << 20)):
            return None
        return run_sharded(comm, ("fused", "scan", op, exclusive),
                           lambda xb: spmd.scan_gather(xb, op, exclusive), x)

    def exscan(self, comm, x, op: Op):
        return self.scan(comm, x, op, exclusive=True)

    def barrier(self, comm):
        _sync(comm)

    # -- v-variants (padded kernels, counts at the host edge) -------------
    def alltoallv(self, comm, sendbufs, sendcounts):
        from . import vcoll

        return vcoll.alltoallv(comm, sendbufs, sendcounts, kernel="lax")

    def allgatherv(self, comm, sendbufs):
        from . import vcoll

        return vcoll.allgatherv(comm, sendbufs, kernel="lax")

    def gatherv(self, comm, sendbufs, root: int):
        from . import vcoll

        return vcoll.gatherv(comm, sendbufs, root, kernel="lax")

    def scatterv(self, comm, sendbuf, counts, root: int):
        from . import vcoll

        return vcoll.scatterv(comm, sendbuf, counts, root)

    def reduce_scatter(self, comm, x, recvcounts, op: Op):
        from . import vcoll

        return vcoll.reduce_scatter(comm, x, recvcounts, op, kernel="lax")


class FusedCollComponent(mca_component.Component):
    NAME = "fused"
    PRIORITY = 100

    def register_vars(self) -> None:
        mca_var.register(
            "coll_xla_scan_gather_limit", "size", 1 << 20,
            "Per-rank bytes above which the fused scan/exscan (gather + "
            "associative scan, n x size staged) defers to tuned's "
            "recursive-doubling scan",
        )

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if getattr(ctx, "spans_processes", False):
            return None  # cross-process comms belong to coll/hier
        return (self.priority, _FusedModule(ctx))


# ---------------------------------------------------------------------------
# tuned component — named algorithms + fixed decision rules
# ---------------------------------------------------------------------------

ALLREDUCE_ALGORITHMS = (
    # mirror of the enum coll_tuned_allreduce.c:46-54
    "auto", "basic_linear", "nonoverlapping", "recursive_doubling",
    "ring", "segmented_ring",
)
BCAST_ALGORITHMS = (
    "auto", "binomial", "binary_tree", "chain", "pipeline", "masked_psum",
)
ALLGATHER_ALGORITHMS = (
    "auto", "ring", "bruck", "recursive_doubling", "lax",
)
ALLTOALL_ALGORITHMS = (
    "auto", "pairwise", "bruck", "basic_linear", "lax",
)
REDUCE_ALGORITHMS = ("auto", "binomial", "in_order_binary", "linear")
# coll_tuned_{gather,scatter}.c menus; both linear_sync branches map to
# linear (the sync round trip protects an eager receiver from overrun,
# which a rank-axis exchange has no analogue of)
GATHER_ALGORITHMS = ("auto", "binomial", "linear")
SCATTER_ALGORITHMS = ("auto", "binomial", "linear")

dynamic_rules.RULE_COLLECTIVES.update({
    "allreduce": ALLREDUCE_ALGORITHMS,
    "bcast": BCAST_ALGORITHMS,
    "allgather": ALLGATHER_ALGORITHMS,
    "alltoall": ALLTOALL_ALGORITHMS,
    "reduce": REDUCE_ALGORITHMS,
    "gather": GATHER_ALGORITHMS,
    "scatter": SCATTER_ALGORITHMS,
})


def _flat_gather(g: torch.Tensor) -> torch.Tensor:
    """(ranks, n blocks, d0, ...) -> each rank's (n*d0, ...) buffer."""
    return g.reshape((g.shape[0], -1) + tuple(g.shape[3:]))


class _TunedModule:
    """Hand-scheduled algorithms with tuned's decision rules; decision
    constants are the reference's (``coll_tuned_decision_fixed.c``)."""

    def __init__(self, comm) -> None:
        self.comm = comm

    def fns(self) -> Dict[str, Callable]:
        return {
            "allreduce": self.allreduce,
            "bcast": self.bcast,
            "reduce": self.reduce,
            "allgather": self.allgather,
            "gather": self.gather,
            "scatter": self.scatter,
            "reduce_scatter_block": self.reduce_scatter_block,
            "alltoall": self.alltoall,
            "scan": self.scan,
            "exscan": self.exscan,
            "barrier": self.barrier,
            "alltoallv": self.alltoallv,
            "allgatherv": self.allgatherv,
            "gatherv": self.gatherv,
            "scatterv": self.scatterv,
            "reduce_scatter": self.reduce_scatter,
        }

    # -- allreduce --------------------------------------------------------
    def _pick_allreduce(self, x, op: Op) -> str:
        """<10 kB per rank -> recursive doubling; commutative with an
        identity and count > comm size -> ring, segmented ring past
        comm_size x segment size; otherwise nonoverlapping."""
        forced = mca_var.get("coll_tuned_allreduce_algorithm", "auto")
        if forced != "auto":
            return forced
        n = self.comm.size
        count = x[0].numel()
        block_dsize = _per_rank_bytes(x)
        dyn = dynamic_rules.lookup("allreduce", n, block_dsize)
        if dyn is not None:
            if dyn in ("ring", "segmented_ring") and (
                    not op.commutative or op.identity is None):
                dyn = "nonoverlapping"  # a rule cannot waive MPI semantics
            return dyn
        if block_dsize < mca_var.get("coll_tuned_small_message", 10000):
            return "recursive_doubling"
        if op.commutative and count > n and op.identity is not None:
            seg = mca_var.get("coll_tuned_segment_size", 1 << 20)
            if n * seg >= block_dsize:
                return "ring"
            return "segmented_ring"
        return "nonoverlapping"

    def allreduce(self, comm, x, op: Op):
        if op.is_pair_op:
            return None  # pair ops stay with fused's gather path
        alg = self._pick_allreduce(x, op)
        if alg in ("ring", "segmented_ring") and (
                not op.commutative or op.identity is None):
            raise MPIError(
                ErrorCode.ERR_ARG,
                "ring allreduce folds chunks in rotating ring order and "
                "pads with the op identity; use nonoverlapping or "
                "recursive_doubling for this op",
            )
        op = _resolve_op(op, x)  # accelerated local-reduction kernel
        n = comm.size
        segsize = mca_var.get("coll_tuned_segment_size", 1 << 20)
        seg_elems = max(1, segsize // x.element_size())
        bodies = {
            "basic_linear": lambda xb: spmd.allreduce_basic_linear(xb, op, n),
            "nonoverlapping": lambda xb: spmd.allreduce_nonoverlapping(
                xb, op, n),
            "recursive_doubling":
                lambda xb: spmd.allreduce_recursive_doubling(xb, op, n),
            "ring": lambda xb: spmd.allreduce_ring(xb, op, n),
            "segmented_ring": lambda xb: spmd.allreduce_segmented_ring(
                xb, op, n, seg_elems),
        }
        if alg == "ring":
            nseg = pipeline.segment_count("allreduce", n, _per_rank_bytes(x))
            if nseg > 1:
                _log.verbose(3, f"{comm.name}: tuned allreduce -> "
                                f"ring pipelined x{nseg}")
                return pipeline.run_pipelined(
                    comm, ("tuned", "allreduce", "ring", op),
                    lambda xb: pipeline.allreduce_ring_pipelined(
                        xb, op, n, nseg),
                    x, nseg=nseg, nbytes=_per_rank_bytes(x),
                    opname="allreduce",
                )
        _log.verbose(3, f"{comm.name}: tuned allreduce -> {alg}")
        key = ("tuned", "allreduce", alg, op) + (
            (seg_elems,) if alg == "segmented_ring" else ())
        return run_sharded(comm, key, bodies[alg], x)

    # -- bcast ------------------------------------------------------------
    def _pick_bcast(self, x) -> tuple:
        """bcast_intra_dec_fixed: < 2048 B -> binomial; < 370728 B ->
        binary_tree; larger -> pipeline with the segment size from the
        reference's regression lines. Returns (algorithm, seg bytes)."""
        forced = mca_var.get("coll_tuned_bcast_algorithm", "auto")
        if forced != "auto":
            return forced, int(mca_var.get(
                "coll_tuned_bcast_segment_size", 128 << 10))
        n = self.comm.size
        msg = _per_rank_bytes(x)
        dyn = dynamic_rules.lookup("bcast", n, msg)
        if dyn is not None:
            return dyn, int(mca_var.get(
                "coll_tuned_bcast_segment_size", 128 << 10))
        if msg < 2048:
            return "binomial", 0
        if msg < 370728:
            return "binary_tree", 1 << 10
        if n < 1.6134e-6 * msg + 2.1102:   # a_p128/b_p128
            return "pipeline", 128 << 10
        if n < 13:
            return "binary_tree", 8 << 10
        if n < 2.3679e-6 * msg + 1.1787:   # a_p64/b_p64
            return "pipeline", 64 << 10
        if n < 3.2118e-6 * msg + 8.7936:   # a_p16/b_p16
            return "pipeline", 16 << 10
        return "pipeline", 8 << 10

    def bcast(self, comm, x, root: int):
        alg, segbytes = self._pick_bcast(x)
        n = comm.size
        seg_elems = max(1, segbytes // x.element_size())
        bodies = {
            "binomial": lambda xb: spmd.bcast_binomial(xb, n, root),
            "binary_tree": lambda xb: spmd.bcast_binary_tree(xb, n, root),
            "chain": lambda xb: spmd.bcast_chain(xb, n, root),
            "pipeline": lambda xb: spmd.bcast_pipeline(xb, n, root,
                                                       seg_elems),
            "masked_psum": lambda xb: spmd.bcast_masked_psum(xb, root),
        }
        if alg == "binomial":
            nseg = pipeline.segment_count("bcast", n, _per_rank_bytes(x))
            if nseg > 1:
                return pipeline.run_pipelined(
                    comm, ("tuned", "bcast", "binomial", root),
                    lambda xb: pipeline.bcast_binomial_pipelined(
                        xb, n, root, nseg),
                    x, nseg=nseg, nbytes=_per_rank_bytes(x),
                    opname="bcast",
                )
        key = ("tuned", "bcast", alg, root) + (
            (seg_elems,) if alg == "pipeline" else ())
        return run_sharded(comm, key, bodies[alg], x)

    # -- reduce -----------------------------------------------------------
    def _pick_reduce(self, x, op: Op) -> str:
        """reduce_intra_dec_fixed: noncommutative -> linear when small
        (< 12 ranks and < 2 kB) else in_order_binary; commutative ->
        linear for tiny (< 8 ranks, < 512 B), binomial otherwise."""
        forced = mca_var.get("coll_tuned_reduce_algorithm", "auto")
        if forced != "auto":
            return forced
        n = self.comm.size
        msg = _per_rank_bytes(x)
        dyn = dynamic_rules.lookup("reduce", n, msg)
        if dyn is not None:
            if not op.commutative and dyn == "binomial":
                dyn = "in_order_binary"  # rule may not break order
            return dyn
        if not op.commutative:
            if n < 12 and msg < 2048:
                return "linear"
            return "in_order_binary"
        if n < 8 and msg < 512:
            return "linear"
        return "binomial"

    def reduce(self, comm, x, op: Op, root: int):
        if op.is_pair_op:
            return None  # pair ops stay with fused's gather path
        n = comm.size
        alg = self._pick_reduce(x, op)
        if alg == "binomial" and not op.commutative:
            raise MPIError(
                ErrorCode.ERR_ARG,
                "binomial reduce rotates operand order by root; use "
                "in_order_binary or linear for a noncommutative op",
            )
        op = _resolve_op(op, x)
        bodies = {
            "binomial": lambda xb: spmd._root_only(
                spmd.reduce_binomial(xb, op, n, root), root),
            "in_order_binary": lambda xb: spmd.reduce_in_order_binary(
                xb, op, n, root),
            "linear": lambda xb: spmd.reduce_linear(xb, op, n, root),
        }
        if alg == "binomial":
            nseg = pipeline.segment_count("reduce", n, _per_rank_bytes(x))
            if nseg > 1:
                return pipeline.run_pipelined(
                    comm, ("tuned", "reduce", "binomial", op, root),
                    lambda xb: spmd._root_only(
                        pipeline.reduce_binomial_pipelined(
                            xb, op, n, root, nseg), root),
                    x, nseg=nseg, nbytes=_per_rank_bytes(x),
                    opname="reduce",
                )
        return run_sharded(comm, ("tuned", "reduce", alg, op, root),
                           bodies[alg], x)

    # -- allgather --------------------------------------------------------
    def _pick_allgather(self, x) -> str:
        """total < 50 kB -> recursive doubling (power-of-two n) else
        bruck; larger -> ring."""
        forced = mca_var.get("coll_tuned_allgather_algorithm", "auto")
        if forced != "auto":
            return forced
        n = self.comm.size
        total = _per_rank_bytes(x) * n
        dyn = dynamic_rules.lookup("allgather", n, total)
        if dyn is not None:
            return dyn
        if total < mca_var.get("coll_tuned_allgather_small_total", 50_000):
            return "recursive_doubling" if n & (n - 1) == 0 else "bruck"
        return "ring"

    def allgather(self, comm, x):
        alg = self._pick_allgather(x)
        n = comm.size
        if alg not in ALLGATHER_ALGORITHMS or alg == "auto":
            raise MPIError(ErrorCode.ERR_ARG,
                           f"unknown allgather algorithm '{alg}' "
                           f"(choices: {ALLGATHER_ALGORITHMS})")
        if alg == "recursive_doubling" and n & (n - 1):
            raise MPIError(ErrorCode.ERR_ARG,
                           f"recursive_doubling allgather needs power-of-two "
                           f"ranks (got {n}); use bruck")
        fn = {
            "ring": lambda xb: spmd.allgather_ring(xb, n),
            "bruck": lambda xb: spmd.allgather_bruck(xb, n),
            "recursive_doubling":
                lambda xb: spmd.allgather_recursive_doubling(xb, n),
            "lax": spmd.allgather_lax,
        }[alg]
        return run_sharded(comm, ("tuned", "allgather", alg),
                           lambda xb: _flat_gather(fn(xb)), x)

    # -- reduce_scatter_block ---------------------------------------------
    def reduce_scatter_block(self, comm, x, op: Op):
        n = comm.size
        if not op.commutative:
            return None
        op = _resolve_op(op, x)
        return run_sharded(comm, ("tuned", "reduce_scatter_block", op),
                           lambda xb: spmd.reduce_scatter_ring(xb, op, n), x)

    # -- alltoall ---------------------------------------------------------
    def _pick_alltoall(self, x) -> str:
        """per-destination block < 200 B at n > 12 -> bruck; block
        < 3000 B -> basic_linear; else pairwise."""
        forced = mca_var.get("coll_tuned_alltoall_algorithm", "auto")
        if forced != "auto":
            return forced
        n = self.comm.size
        block = _per_rank_bytes(x) // max(1, n)
        dyn = dynamic_rules.lookup("alltoall", n, block)
        if dyn is not None:
            return dyn
        if block < 200 and n > 12:
            return "bruck"
        if block < 3000:
            return "basic_linear"
        return "pairwise"

    def alltoall(self, comm, x):
        alg = self._pick_alltoall(x)
        if alg not in ALLTOALL_ALGORITHMS or alg == "auto":
            raise MPIError(ErrorCode.ERR_ARG,
                           f"unknown alltoall algorithm '{alg}' "
                           f"(choices: {ALLTOALL_ALGORITHMS})")
        n = comm.size
        fn = {
            "lax": spmd.alltoall_lax,
            "basic_linear": spmd.alltoall_lax,  # one-shot posted set
            "bruck": spmd.alltoall_bruck,
            "pairwise": spmd.alltoall_pairwise,
        }[alg]

        def body(xb):
            blocks = xb.reshape((n, n, -1) + tuple(xb.shape[2:]))
            return fn(blocks, n).reshape(xb.shape)

        return run_sharded(comm, ("tuned", "alltoall", alg), body, x)

    # -- gather / scatter (coll_tuned_{gather,scatter}.c) -----------------
    def _pick_gather(self, x) -> str:
        """gather_intra_dec_fixed: block > 6000 B -> linear (both
        linear_sync branches); n > 60, or n > 10 with block < 1024 B ->
        binomial; else linear."""
        forced = mca_var.get("coll_tuned_gather_algorithm", "auto")
        if forced != "auto":
            return forced
        n = self.comm.size
        block = _per_rank_bytes(x)
        dyn = dynamic_rules.lookup("gather", n, block)
        if dyn is not None:
            return dyn
        if block > 6000:
            return "linear"
        if n > 60 or (n > 10 and block < 1024):
            return "binomial"
        return "linear"

    def gather(self, comm, x, root: int):
        alg = self._pick_gather(x)
        n = comm.size
        if alg == "binomial":
            body = lambda xb: spmd.gather_binomial(xb, n, root)  # noqa: E731
        else:
            body = lambda xb: spmd.gather_linear(xb, n, root)  # noqa: E731
        return run_sharded(comm, ("tuned", "gather", alg, root), body, x)

    def _pick_scatter(self, x) -> str:
        """scatter_intra_dec_fixed: n > 10 with block < 300 B ->
        binomial; else linear. The block is root's per-destination
        chunk."""
        forced = mca_var.get("coll_tuned_scatter_algorithm", "auto")
        if forced != "auto":
            return forced
        n = self.comm.size
        block = _per_rank_bytes(x) // max(1, n)
        dyn = dynamic_rules.lookup("scatter", n, block)
        if dyn is not None:
            return dyn
        return "binomial" if (n > 10 and block < 300) else "linear"

    def scatter(self, comm, x, root: int):
        n = comm.size
        alg = self._pick_scatter(x)
        if alg == "binomial":
            body = lambda xb: spmd.scatter_binomial(xb, n, root)  # noqa: E731
        else:
            body = lambda xb: spmd.scatter_linear(xb, n, root)  # noqa: E731
        return run_sharded(comm, ("tuned", "scatter", alg, root), body, x)

    # -- scan / exscan ----------------------------------------------------
    def scan(self, comm, x, op: Op):
        if op.is_pair_op:
            return None  # pair scans stay with fused's gather path
        n = comm.size
        return run_sharded(
            comm, ("tuned", "scan", op),
            lambda xb: spmd.scan_recursive_doubling(xb, op, n), x)

    def exscan(self, comm, x, op: Op):
        if op.is_pair_op:
            return None
        n = comm.size
        return run_sharded(
            comm, ("tuned", "exscan", op),
            lambda xb: spmd.scan_recursive_doubling(xb, op, n,
                                                    exclusive=True), x)

    def barrier(self, comm):
        _sync(comm)

    # -- v-variants: tuned's hand schedules on the padded kernels ----------
    def alltoallv(self, comm, sendbufs, sendcounts):
        from . import vcoll

        return vcoll.alltoallv(comm, sendbufs, sendcounts,
                               kernel="pairwise")

    def allgatherv(self, comm, sendbufs):
        from . import vcoll

        return vcoll.allgatherv(comm, sendbufs, kernel="ring")

    def gatherv(self, comm, sendbufs, root: int):
        from . import vcoll

        return vcoll.gatherv(comm, sendbufs, root, kernel="ring")

    def scatterv(self, comm, sendbuf, counts, root: int):
        from . import vcoll

        return vcoll.scatterv(comm, sendbuf, counts, root)

    def reduce_scatter(self, comm, x, recvcounts, op: Op):
        if not op.commutative or op.identity is None:
            return None  # fused's allreduce + slice path handles these
        from . import vcoll

        return vcoll.reduce_scatter(comm, x, recvcounts, op, kernel="ring")


class TunedCollComponent(mca_component.Component):
    NAME = "tuned"
    PRIORITY = 50

    def register_vars(self) -> None:
        for coll, algs in (("allreduce", ALLREDUCE_ALGORITHMS),
                           ("bcast", BCAST_ALGORITHMS),
                           ("allgather", ALLGATHER_ALGORITHMS),
                           ("alltoall", ALLTOALL_ALGORITHMS),
                           ("reduce", REDUCE_ALGORITHMS),
                           ("gather", GATHER_ALGORITHMS),
                           ("scatter", SCATTER_ALGORITHMS)):
            mca_var.register(
                f"coll_tuned_{coll}_algorithm", "enum", "auto",
                f"Force a specific {coll} algorithm", choices=algs,
            )
        mca_var.register(
            "coll_tuned_small_message", "size", 10000,
            "Below this many bytes per rank, allreduce uses recursive "
            "doubling (coll_tuned_decision_fixed.c:51)",
        )
        mca_var.register(
            "coll_tuned_segment_size", "size", 1 << 20,
            "Ring segment size (coll_tuned_decision_fixed.c:71)",
        )
        mca_var.register(
            "coll_tuned_bcast_segment_size", "size", 128 << 10,
            "Segment size for a FORCED pipeline bcast (auto mode uses "
            "the reference's regression-picked 8-128 KiB)",
        )
        mca_var.register(
            "coll_tuned_allgather_small_total", "size", 50_000,
            "Below this many TOTAL bytes, allgather uses recursive "
            "doubling (power-of-two ranks) or bruck",
        )
        mca_var.register(
            "coll_tuned_use_dynamic_rules", "bool", False,
            "Consult the dynamic rule file between operator forcing "
            "and the fixed decision constants",
        )
        mca_var.register(
            "coll_tuned_dynamic_rules_filename", "str", "",
            "Rule file: 'collective min_comm_size min_msg_bytes "
            "algorithm [segsize]' lines, last match wins",
        )

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if getattr(ctx, "spans_processes", False):
            return None  # cross-process comms belong to coll/hier
        return (self.priority, _TunedModule(ctx))


# ---------------------------------------------------------------------------
# basic component — linear reference algorithms (always correct)
# ---------------------------------------------------------------------------

class _BasicModule:
    """Linear algorithms (``ompi/mca/coll/basic``): the correctness
    yardstick."""

    def __init__(self, comm) -> None:
        self.comm = comm

    def fns(self) -> Dict[str, Callable]:
        return {"allreduce": self.allreduce, "reduce": self.reduce,
                "scatter": self.scatter, "gather": self.gather}

    def allreduce(self, comm, x, op: Op):
        if op.is_pair_op:
            return None
        n = comm.size
        op = _resolve_op(op, x)
        return run_sharded(comm, ("basic", "allreduce", op),
                           lambda xb: spmd.allreduce_basic_linear(xb, op, n),
                           x)

    def reduce(self, comm, x, op: Op, root: int):
        if op.is_pair_op:
            return None
        n = comm.size
        op = _resolve_op(op, x)
        return run_sharded(comm, ("basic", "reduce", op, root),
                           lambda xb: spmd.reduce_linear(xb, op, n, root), x)

    def scatter(self, comm, x, root: int):
        n = comm.size
        return run_sharded(comm, ("basic", "scatter", root),
                           lambda xb: spmd.scatter_linear(xb, n, root), x)

    def gather(self, comm, x, root: int):
        n = comm.size
        return run_sharded(comm, ("basic", "gather", root),
                           lambda xb: spmd.gather_linear(xb, n, root), x)


class BasicCollComponent(mca_component.Component):
    NAME = "basic"
    PRIORITY = 10

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if getattr(ctx, "spans_processes", False):
            return None  # cross-process comms belong to coll/hier
        return (self.priority, _BasicModule(ctx))


# ---------------------------------------------------------------------------
# self component — size-1 communicators
# ---------------------------------------------------------------------------

class _SelfModule:
    def __init__(self, comm) -> None:
        self.comm = comm

    def fns(self) -> Dict[str, Callable]:
        def same(comm, x, *a):
            return x.clone()

        return {
            "allreduce": same,
            "reduce": same,
            "bcast": same,
            "allgather": same,
            "gather": same,
            "scatter": same,
            "reduce_scatter_block": same,
            "alltoall": same,
            "scan": same,
            "exscan": lambda comm, x, op: torch.zeros_like(x),
            "barrier": lambda comm: _sync(comm),
            # v-variants on one rank: local identities with the vcoll
            # path's validation and 1-D flattening, so callers see the
            # same shapes on any comm size
            "alltoallv": self._alltoallv,
            "allgatherv": self._allgatherv,
            "gatherv": lambda comm, bufs, root: self._allgatherv(comm, bufs),
            "scatterv": self._scatterv,
            "reduce_scatter": self._reduce_scatter,
        }

    @staticmethod
    def _alltoallv(comm, bufs, counts):
        from . import vcoll

        b = vcoll._as_1d_tensors(comm, bufs, "alltoallv")
        c = vcoll._counts_matrix(counts, 1)
        if b[0].shape[0] != int(c[0, 0]):
            raise MPIError(
                ErrorCode.ERR_COUNT,
                f"alltoallv buffer has {b[0].shape[0]} elements, count "
                f"is {int(c[0, 0])}",
            )
        return [b[0].clone()]

    @staticmethod
    def _allgatherv(comm, bufs):
        from . import vcoll

        return vcoll._as_1d_tensors(comm, bufs, "allgatherv")[0].clone()

    @staticmethod
    def _scatterv(comm, buf, counts, root):
        from .driver import as_rank_buffer

        if root != 0:
            raise MPIError(ErrorCode.ERR_ROOT, f"bad root {root}")
        flat = as_rank_buffer(buf, comm.device).reshape(-1)
        counts = [int(k) for k in counts]
        if len(counts) != 1 or flat.shape[0] != counts[0]:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                "scatterv needs 1 count matching the buffer length",
            )
        return [flat.clone()]

    @staticmethod
    def _reduce_scatter(comm, x, counts, op):
        from .driver import as_rank_buffer

        flat = as_rank_buffer(x, comm.device).reshape(-1)
        counts = [int(k) for k in counts]
        if len(counts) != 1 or flat.shape[0] != counts[0]:
            raise MPIError(
                ErrorCode.ERR_COUNT,
                "reduce_scatter on a self comm needs x of shape "
                "(1, recvcounts[0])",
            )
        return [flat.clone()]


class SelfCollComponent(mca_component.Component):
    NAME = "self"
    PRIORITY = 0

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if ctx.size == 1:
            return (1000, _SelfModule(ctx))  # claim size-1 comms outright
        return None


# ---------------------------------------------------------------------------
# ml component — hierarchical two-level collectives (ml/bcol/sbgp)
# ---------------------------------------------------------------------------

def _discover_hierarchy(comm) -> Optional[tuple]:
    """sbgp-style subgroup discovery: split the comm's ranks into fast
    domains (same host process / slice). Returns (inter, intra) when
    ranks form equal-size contiguous groups, else None. The
    ``coll_ml_local_size`` variable overrides discovery (virtual ranks
    all share one process)."""
    forced = int(mca_var.get("coll_ml_local_size", 0))
    n = comm.size
    if forced > 1:
        return (n // forced, forced) if n % forced == 0 else None
    eps = {e.rank: e for e in comm.runtime.endpoints}
    keys = []
    for i in range(n):
        e = eps.get(comm.group.world_rank(i))
        if e is None:
            return None
        keys.append((e.process_index, e.slice_index))
    groups: Dict[tuple, list] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    sizes = {len(v) for v in groups.values()}
    if len(groups) < 2 or len(sizes) != 1:
        return None
    intra = sizes.pop()
    if intra < 2:
        return None
    # groups must be contiguous rank blocks for the 2-D factorization
    for members in groups.values():
        if members != list(range(members[0], members[0] + intra)):
            return None
    return (len(groups), intra)


class _MlModule:
    """Two-level algorithms over the (node, local) decomposition."""

    def __init__(self, comm, inter: int, intra: int) -> None:
        self.comm = comm
        self.inter = inter
        self.intra = intra

    def fns(self) -> Dict[str, Callable]:
        return {
            "allreduce": self.allreduce,
            "reduce": self.reduce,
            "bcast": self.bcast,
            "allgather": self.allgather,
            "reduce_scatter_block": self.reduce_scatter_block,
            "alltoall": self.alltoall,
            "barrier": self.barrier,
        }

    def _reducible(self, op: Op) -> bool:
        return not (op.is_pair_op or op.identity is None
                    or not op.commutative)

    def _run(self, comm, key: tuple, body, x):
        return run_sharded2d(comm, ("ml",) + key + (self.inter, self.intra),
                             body, x, inter=self.inter, intra=self.intra)

    def allreduce(self, comm, x, op: Op):
        if not self._reducible(op):
            return None  # defer to lower-priority providers
        op = _resolve_op(op, x)
        return self._run(comm, ("allreduce", op), lambda xb:
                         spmd.allreduce_two_level(xb, op, self.inter,
                                                  self.intra), x)

    def reduce(self, comm, x, op: Op, root: int):
        if not self._reducible(op):
            return None
        op = _resolve_op(op, x)
        return self._run(comm, ("reduce", op, root), lambda xb:
                         spmd.reduce_two_level(xb, op, self.inter,
                                               self.intra, root), x)

    def allgather(self, comm, x):
        return self._run(comm, ("allgather",), lambda xb: _flat_gather(
            spmd.allgather_two_level(xb, self.inter, self.intra)), x)

    def reduce_scatter_block(self, comm, x, op: Op):
        if not self._reducible(op):
            return None
        op = _resolve_op(op, x)
        return self._run(comm, ("reduce_scatter_block", op), lambda xb:
                         spmd.reduce_scatter_two_level(xb, op, self.inter,
                                                       self.intra), x)

    def alltoall(self, comm, x):
        n = comm.size

        def body(xb):
            blocks = xb.reshape((n, n, -1) + tuple(xb.shape[2:]))
            return spmd.alltoall_two_level(
                blocks, self.inter, self.intra).reshape(xb.shape)

        return self._run(comm, ("alltoall",), body, x)

    def bcast(self, comm, x, root: int):
        return self._run(comm, ("bcast", root), lambda xb:
                         spmd.bcast_two_level(xb, self.inter, self.intra,
                                              root), x)

    def barrier(self, comm):
        self._run(comm, ("barrier",), spmd.barrier_psum,
                  torch.zeros((comm.size,), dtype=torch.int32,
                              device=comm.device))
        _sync(comm)


class MlCollComponent(mca_component.Component):
    """Hierarchical collectives; wins only when selected (coll=ml) or
    its priority is raised, and declines comms with no hierarchy."""

    NAME = "ml"
    PRIORITY = 40

    def register_vars(self) -> None:
        mca_var.register(
            "coll_ml_local_size", "int", 0,
            "Force the fast-domain (intra) size for hierarchical "
            "collectives; 0 = discover from endpoint process/slice ids",
        )

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, self)
        if getattr(ctx, "spans_processes", False):
            return None  # cross-process comms belong to coll/hier
        h = _discover_hierarchy(ctx)
        if h is None:
            return None
        return (self.priority, _MlModule(ctx, *h))


from .hier import HierCollComponent  # noqa: E402  (registration order)

COLL_FRAMEWORK.register(FusedCollComponent())
COLL_FRAMEWORK.register(TunedCollComponent())
COLL_FRAMEWORK.register(MlCollComponent())
COLL_FRAMEWORK.register(BasicCollComponent())
COLL_FRAMEWORK.register(SelfCollComponent())
COLL_FRAMEWORK.register(HierCollComponent())
